// The persistent 16-input-channel int8 conv on the tensor cores (the
// tap-pair loop conv16_mma of conv_mma.cuh), shared by kernels B and C
// (csrc/conv_i8.cu: 16 -> 16 at 256², with the phase mean for B, two inputs
// for C) and by kernels G and H at db1 (csrc/conv_px.cu: 16 -> 16 at 128²
// with the residual add for G's res.conv2, 16 -> 32 with the 2x2 pool for
// H).
//
// Persistent blocks keep the weights in registers (W16Frags: 18 words a
// lane at 16 output channels, 36 at 32) and stream TH x 32 output tiles
// through a cp.async halo ring; each warp takes TH / 8 consecutive tile rows,
// RPP 32-pixel rows (2 * RPP m16 tiles) at a time, stages the requantised
// bytes in shared memory and writes them as coalesced 16-byte stores (a
// pixel of 32 channels as two), and the pool takes the 2x2 cells of the
// warp's own row pairs from the staged tile, so it needs no block barrier.
// The epilogue's conversions go on the float and integer pipes (i2f_small,
// requant_bits: the same values as __int2float_rn and rintf; a 16-channel
// accumulator stays below 2^22 whatever COUT is), since Hopper converts 16
// values a clock an SM.
//
// The outlay (kernel F, and the generic entry at 16 -> 1) is a sibling on the
// same ring and loop at one n8 tile: one float32 value a pixel, no staging.

#pragma once

#include "conv_mma.cuh"

namespace {
namespace tc {

// NIN 16-channel int8 inputs (C two: conv(concat(x, z)) as two convs whose
// concat is never formed), each with its weights (HWIO (3,3,16,COUT)),
// dequantise scale and int32 accumulators; COUT int8 outputs
//   requant(relu(acc_0*scale_0 [+ acc_1*scale_1] + bias))
// each product rounded, their sum rounded, then + bias rounded. With RES
// (G's res.conv2) the ReLU'd value gets res (N,H,W,COUT) int8 times res_sc
// added before the requantise, the product rounded first. With PM (B's phase
// mean, H's pool) also pm (N,H/2,W/2,COUT): rint(float(int32 sum of the
// requantised 2x2 cell) * pm_scale), clipped.
template <int NIN>
struct Conv16Args {
  const int8_t* x[NIN];
  const int8_t* wt[NIN];
  const float* scale[NIN];
  const float* bias;
  int8_t* out;
  int8_t* pm;
  float pm_scale;
  const int8_t* res;
  float res_sc;
  int n, h, w, relu;
};

constexpr int C16_TW = 32;  // tile width: two m16 tiles a row

// Shared memory: the requantised output tile (swizzled rows of COUT bytes;
// the residual is staged there first), then STAGES halo stages of NIN inputs.
template <int NIN, int COUT, int TH, int STAGES>
struct Conv16Layout {
  static constexpr int HH = TH + 2, HWD = C16_TW + 2;
  static constexpr size_t HALO = (size_t)HH * HWD * 16;  // one input's
  static constexpr size_t OFF_HALO = (size_t)TH * C16_TW * COUT;
  static constexpr size_t BYTES = OFF_HALO + (size_t)STAGES * NIN * HALO;
};

// Start the copies of tile t's NIN halos (TH x C16_TW output tiles, tiles_x
// a tile row, per_img an image) into stage `stage` of the ring at `ring`;
// past the last tile nothing is copied. Commits the group either way.
template <int NIN, int TH>
__device__ __forceinline__ void issue_halo16(int8_t* ring, const int8_t* const (&x)[NIN], int t,
                                             int stage, int n_tiles, int tiles_x, int per_img,
                                             int h, int w) {
  constexpr int HH = TH + 2, HWD = C16_TW + 2;
  constexpr size_t HALO = (size_t)HH * HWD * 16;
  if (t < n_tiles) {
    const int img = t / per_img, r = t % per_img;
    const int y0 = (r / tiles_x) * TH - 1, x0 = (r % tiles_x) * C16_TW - 1;
#pragma unroll
    for (int i = 0; i < NIN; ++i)
      load_halo_async<16, HH, HWD>(ring + (stage * NIN + i) * HALO, x[i], img, y0, x0, h, w);
  }
  cp_async_commit();
}

template <int NIN, int COUT, bool PM, bool RES, int TH, int RPP, int STAGES, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
conv16_mma_kernel(const Conv16Args<NIN> a) {
  using L = Conv16Layout<NIN, COUT, TH, STAGES>;
  constexpr int NT = COUT / 8, CH = COUT / 16;                   // n8 tiles, 16-byte chunks
  constexpr int RPW = TH / WARPS, MT = 2 * RPP;                  // tile rows a warp, m16 tiles a pass
  static_assert(COUT == 16 || COUT == 32, "16 or 32 output channels");
  static_assert(TH % WARPS == 0 && RPW % RPP == 0 && (!PM || RPW % 2 == 0),
                "whole rows a warp and a pass, and row pairs for the pool");
  static_assert(!RES || NIN == 1, "the residual add has one input");
  extern __shared__ __align__(128) int8_t tc_smem[];
  const int h = a.h, w = a.w;
  const int tiles_x = (w + C16_TW - 1) / C16_TW, per_img = tiles_x * ((h + TH - 1) / TH);
  const int n_tiles = a.n * per_img;
  auto issue = [&](int t, int stage) {
    issue_halo16<NIN, TH>(tc_smem + L::OFF_HALO, a.x, t, stage, n_tiles, tiles_x, per_img, h, w);
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  W16Frags<NT> wf[NIN];
  float sc[NIN][NT][2], bi[NT][2];  // of this lane's channels 8j + 2tq + e
#pragma unroll
  for (int i = 0; i < NIN; ++i) load_w16(wf[i], a.wt[i]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bi[j][e] = __ldg(a.bias + 8 * j + 2 * tq + e);
#pragma unroll
      for (int i = 0; i < NIN; ++i) sc[i][j][e] = __ldg(a.scale[i] + 8 * j + 2 * tq + e);
    }
  int8_t* s_o = tc_smem + warp * RPW * C16_TW * COUT;  // this warp's rows of the output tile
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile's halos are in; the last tile's stage and s_o are free
    const int img = t / per_img, rt = t % per_img;
    const int y0 = (rt / tiles_x) * TH + warp * RPW, x0 = (rt % tiles_x) * C16_TW;
    if constexpr (RES) {
      // the residual of this warp's rows into s_o, where each lane's
      // epilogue reads it back from the bytes it then overwrites; past the
      // ragged edge the clamped pixel stands in (its output is not stored)
      const uint32_t so = smem_u32(s_o);
      for (int k = lane; k < RPW * C16_TW * CH; k += 32) {
        const int pix = k / CH, c = k % CH;
        const int gy = min(y0 + pix / C16_TW, h - 1), gx = min(x0 + pix % C16_TW, w - 1);
        cp_async16(so + swz<CH>(pix, c) * 16, a.res + (((size_t)img * h + gy) * w + gx) * COUT + c * 16);
      }
      cp_async_commit();
    }
    issue(t + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES);
    const int8_t* sh = tc_smem + L::OFF_HALO + (it % STAGES) * NIN * L::HALO;
#pragma unroll 1
    for (int r = 0; r < RPW; r += RPP) {
      int p0[MT];  // m16 tile m: row r + m / 2 of the warp's, pixels 16 (m % 2) + 0..15
#pragma unroll
      for (int m = 0; m < MT; ++m)
        p0[m] = (warp * RPW + r + m / 2) * L::HWD + 16 * (m % 2) + a_row();
      int acc[NIN][MT][NT][4] = {};
#pragma unroll
      for (int i = 0; i < NIN; ++i) conv16_mma<L::HWD, MT, NT>(acc[i], sh + i * L::HALO, wf[i], p0);
      if constexpr (RES) {
        if (r == 0) {
          cp_async_wait<1>();  // the residual; the halo issued after it may still fly
          __syncwarp();
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pix = (r + m / 2) * C16_TW + 16 * (m % 2) + g + 8 * hf;
            uint16_t* dst = reinterpret_cast<uint16_t*>(s_o + swz<CH>(pix, j / 2) * 16 +
                                                         8 * (j % 2) + 2 * tq);
            uint32_t v0 = 0;
            if constexpr (RES) v0 = *dst;
            uint32_t q[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float y = __fmul_rn(i2f_small(acc[0][m][j][2 * hf + e]), sc[0][j][e]);
#pragma unroll
              for (int i = 1; i < NIN; ++i)
                y = __fadd_rn(y, __fmul_rn(i2f_small(acc[i][m][j][2 * hf + e]), sc[i][j][e]));
              y = __fadd_rn(y, bi[j][e]);
              if constexpr (RES) {
                if (a.relu) y = fmaxf(y, 0.f);
                const int v = (int8_t)(v0 >> (8 * e));
                q[e] = requant_bits(__fadd_rn(__fmul_rn(i2f_small(v), a.res_sc), y), false);
              } else {
                q[e] = requant_bits(y, a.relu);
              }
            }
            *dst = (uint16_t)__byte_perm(q[0], q[1], 0x0040);
          }
    }
    __syncwarp();
    for (int k = lane; k < RPW * C16_TW * CH; k += 32) {
      const int pix = k / CH, c = k % CH;
      const int gy = y0 + pix / C16_TW, gx = x0 + pix % C16_TW;
      if (gy < h && gx < w)
        *reinterpret_cast<uint4*>(a.out + (((size_t)img * h + gy) * w + gx) * COUT + c * 16) =
            *reinterpret_cast<const uint4*>(s_o + swz<CH>(pix, c) * 16);
    }
    if constexpr (PM) {
      // the 2x2 cells of this warp's row pairs (y0 and x0 are even); cells
      // past the ragged edge write nothing
      for (int k = lane; k < RPW / 2 * C16_TW / 2 * CH; k += 32) {
        const int c = k % CH, cell = k / CH;
        const int pr = cell / (C16_TW / 2), px = cell % (C16_TW / 2);
        const int gpy = y0 / 2 + pr, gpx = x0 / 2 + px;
        if (gpy >= h / 2 || gpx >= w / 2) continue;
        const int pix = 2 * pr * C16_TW + 2 * px;
        int8_t a0[16], a1[16], b0[16], b1[16], p[16];
        unpack16(a0, *reinterpret_cast<const uint4*>(s_o + swz<CH>(pix, c) * 16));
        unpack16(a1, *reinterpret_cast<const uint4*>(s_o + swz<CH>(pix + 1, c) * 16));
        unpack16(b0, *reinterpret_cast<const uint4*>(s_o + swz<CH>(pix + C16_TW, c) * 16));
        unpack16(b1, *reinterpret_cast<const uint4*>(s_o + swz<CH>(pix + C16_TW + 1, c) * 16));
#pragma unroll
        for (int co = 0; co < 16; ++co) {
          const int sum4 = (int)a0[co] + (int)a1[co] + (int)b0[co] + (int)b1[co];
          p[co] = (int8_t)requant_bits(__fmul_rn(i2f_small(sum4), a.pm_scale), false);
        }
        store16(a.pm + (((size_t)img * (h / 2) + gpy) * (w / 2) + gpx) * COUT + c * 16, p);
      }
    }
  }
  cp_async_wait<0>();
}

// What an instance launches for a shape: its shared memory a block and the
// tiles its persistent blocks walk (the launch and the shape queries read
// it here; tc::entry_shape).
template <int NIN, int COUT, bool PM, bool RES, int TH, int RPP, int STAGES, int MINB>
struct Conv16Entry {
  static constexpr size_t SMEM = Conv16Layout<NIN, COUT, TH, STAGES>::BYTES;
  static auto kernel() { return conv16_mma_kernel<NIN, COUT, PM, RES, TH, RPP, STAGES, MINB>; }
  static int tiles(int n, int h, int w) {
    return n * ((h + TH - 1) / TH) * ((w + C16_TW - 1) / C16_TW);
  }
  static int launch(const Conv16Args<NIN>& a, cudaStream_t s) {
    return launch_persistent(kernel(), SMEM, tiles(a.n, a.h, a.w), s, a);
  }
};

// The outlay: x (N,H,W,16) int8 -> out (N,H,W) float32
//   y = acc * scale + bias [ReLU]
// (two roundings; the caller folds the input scale and the Kelvin
// de-normalise into the two scalars). conv16_mma at one n8 tile: column 0
// holds the weights, columns 1-7 zeros, 5 products an m16 tile. Each warp
// takes TH / 8 tile rows, a 32-pixel row (two m16 tiles) at a time; channel 0
// of pixel p of the row sits in lane 4 (p % 8), register c0 (p % 16 < 8) or c2,
// of m16 tile p / 16, so four shuffles give lane p its pixel and the warp
// writes the row as one 128-byte store. Shared memory is the halo ring only.
template <int TH, int STAGES, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
conv16_outlay_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         float* __restrict__ out, int n, int h, int w, int relu) {
  constexpr int HWD = C16_TW + 2, RPW = TH / WARPS;
  constexpr size_t HALO = (size_t)(TH + 2) * HWD * 16;
  static_assert(TH % WARPS == 0, "whole rows a warp");
  extern __shared__ __align__(128) int8_t tc_smem[];
  const int tiles_x = (w + C16_TW - 1) / C16_TW, per_img = tiles_x * ((h + TH - 1) / TH);
  const int n_tiles = n * per_img;
  const int8_t* const xs[1] = {x};
  for (int s = 0; s < STAGES - 1; ++s)
    issue_halo16<1, TH>(tc_smem, xs, blockIdx.x + s * gridDim.x, s, n_tiles, tiles_x, per_img,
                        h, w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  W16Frags<1> wf;
  load_w16<1, 1>(wf, wt);
  const float sc = __ldg(scale), bi = __ldg(bias);
  const int src = 4 * (lane & 7), part = lane >> 3;  // the lane and value of this lane's pixel
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile's halo is in; the last tile's stage is free
    issue_halo16<1, TH>(tc_smem, xs, t + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES,
                        n_tiles, tiles_x, per_img, h, w);
    const int img = t / per_img, rt = t % per_img;
    const int y0 = (rt / tiles_x) * TH + warp * RPW, gx = (rt % tiles_x) * C16_TW + lane;
    const int8_t* sh = tc_smem + (it % STAGES) * HALO;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int p0[2] = {(warp * RPW + r) * HWD + a_row(), (warp * RPW + r) * HWD + 16 + a_row()};
      int acc[2][1][4] = {};
      conv16_mma<HWD, 2, 1>(acc, sh, wf, p0);
      const int v0 = __shfl_sync(0xffffffffu, acc[0][0][0], src);
      const int v1 = __shfl_sync(0xffffffffu, acc[0][0][2], src);
      const int v2 = __shfl_sync(0xffffffffu, acc[1][0][0], src);
      const int v3 = __shfl_sync(0xffffffffu, acc[1][0][2], src);
      const int v = part == 0 ? v0 : part == 1 ? v1 : part == 2 ? v2 : v3;
      float y = __fadd_rn(__fmul_rn(i2f_small(v), sc), bi);
      if (relu) y = fmaxf(y, 0.f);
      const int gy = y0 + r;
      if (gy < h && gx < w) out[((size_t)img * h + gy) * w + gx] = y;
    }
  }
  cp_async_wait<0>();
}

template <int TH, int STAGES, int MINB>
struct OutlayEntry {
  static constexpr size_t SMEM = (size_t)STAGES * (TH + 2) * (C16_TW + 2) * 16;
  static auto kernel() { return conv16_outlay_mma_kernel<TH, STAGES, MINB>; }
  static int tiles(int n, int h, int w) {
    return n * ((h + TH - 1) / TH) * ((w + C16_TW - 1) / C16_TW);
  }
  static int launch(const int8_t* x, const int8_t* wt, const float* scale, const float* bias,
                    float* out, int n, int h, int w, int relu, cudaStream_t s) {
    return launch_persistent(kernel(), SMEM, tiles(n, h, w), s, x, wt, scale, bias, out, n, h,
                             w, relu);
  }
};

}  // namespace tc
}  // namespace
