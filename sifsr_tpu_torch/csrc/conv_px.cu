// The int8 mid chain of the serving step (db1..db3, ub1, ub2 at 128²/64²/32²):
// replicate-pad 3x3 int8 convs on NHWC tensors with fused epilogues.
//
// Replaces, from sifsr_tpu/pallas/conv_px.py:
//   conv_prow             (pl.pallas_call at conv_px.py:363/:375/:385; entry
//                          sifsr_conv_prow, with the optional residual add)
//   conv_prow_split_pool  (conv_px.py:505; entry sifsr_conv_prow_split_pool)
//   conv_prow_up2         (conv_px.py:1002/:1025; entry sifsr_conv_prow_up2)
//   conv_prow_up2_pack    (conv_px.py:927/:949; the same entry: the
//                          space-to-depth pair-row pack is a TPU layout)
//   conv_prow_dual_planes (conv_px.py:563, _conv_dual_planes_kernel at
//                          :532-544; entry sifsr_conv_prow_dual at 32 and 64
//                          channels: the half-plane interleave is a layout)
//   conv_prow_dual        (conv_px.py:409; the same entry: with the skip as
//                          one NHWC tensor its function is the planes form's)
//
// The TPU kernels hold a tensor as p-pixel rows (p*C = 128 lanes), split
// half-planes and e-major pixel groups, and pack the conv into banded
// matmuls, all of it to fill 128 TPU lanes. These take unpacked NHWC int8
// and keep only the function, with the Pallas kernels' rounding points:
//   G: requant(relu(acc*sc + b)); with a residual v0,
//      requant(float(v0)*res_sc + relu(acc*sc + b)), product rounded first;
//   H: the requantised conv output (the decoder skip) and the exact 2x2 pool
//      of it: requant(float(int32 sum of the 2x2 int8 cell) * pool_sc);
//   I, K: the conv requantised at the mid scale, then the align-corners x2
//      in integer arithmetic (the integer-exact row mix of up2_impl='mxu'):
//      y = sum_j cnum[l+dj] * sum_i rnum[k+di] * q, exact in int32 and below
//      2^24, then one rounding rint(float(y) * inv) and the clip;
//      or, with float32 tables (entry sifsr_conv_prow_up2_vpu), the roll/fma
//      chain of up2_impl='vpu' (_conv_up2_kernel, conv_px.py:582-631): a row
//      pass r = sum_t rc[d,t][k] * float(q[k+t-1]) and a column pass
//      y = sum_u cc[e,u][l] * r[l+u-1] in float32, taps in ascending order,
//      every product and sum rounded on its own, then rint(y * inv), clip:
//      three roundings where the integer form has one. rc carries the mid
//      scale, inv = 1 / s_up;
//   J: requant(relu(acc_x*sc_x + acc_z*sc_z + b)).
//
// Bound on the H100: memory at the serving shapes (int8 tensors of 1-5 MB
// per image against a few tens of M int8 multiply-adds). All of them run on
// the int8 tensor cores (the main loops of conv_mma.cuh), in persistent
// blocks that keep their weights on chip and stream input halos through a
// cp.async ring:
//   G, H at db1 (16 channels in, 128²): the 16-channel kernel of conv16.cuh
//     that B and C share (tap pairs, weights in registers), with G's
//     residual staged through the output tile and H's pool from its row
//     pairs. The dp4a loop they replace took, for a G call, 0.30-0.37 ms on the INT32
//     pipe for 12.2 G multiply-adds and for an H call 0.55-0.60 ms for
//     24.5 G, against 0.01-0.09 ms of bytes (H100, batch 324).
//   G, H at db2 and db3 (32 / 64 channels, 64² / 32²): conv_prow_mma_kernel,
//     J's design with one input: weights as swizzled [tap][cout][cin] rows in
//     shared memory, 8x32 tiles in units of two rows by 16 columns a warp (the
//     pool's 2x2 cell in two lanes, one shuffle apart), the requantised
//     bytes staged per warp and written as coalesced 16-byte stores.
//   J, L (batch 324: ub1.conv1 64 ch at 64², ub2.conv1 32 ch at 128²): 97.8 G
//     int8 multiply-adds a call, 0.198 ms of operations at 1,979 TOP/s for
//     both calls against 0.228 ms of bytes (255 + 510 MB at 3.35 TB/s): near
//     the ridge, so the MMA loop matters as much as the bytes. 8x32 output
//     tiles, warp w takes row w (two m16 pixel tiles) and every output
//     channel, with an int32 accumulator set per input (the two scales round
//     apart); the requantised bytes are staged in shared memory per warp
//     and leave as coalesced 16-byte stores.
//   I, K (db3 last 64->64 at 32², ub1.conv2 64->32 at 64²; ub2.conv2 32->16
//     at 128²): bytes-bound (0.108 and 0.152 ms against about 0.06 ms of
//     operations: the x2 quadruples the output). The conv runs over the
//     source tile and its one-pixel ring, linearised into m16 tiles, and is
//     requantised into shared memory, from which the x2 writes the output
//     tile; the ring's values past the image border meet zero coefficients.
//     I takes 8x32 source tiles (a 10x34 region, 22 m16 tiles, three a warp:
//     1.5x the tile's multiply-adds), K 16x32 ones (18x34, 39 m16 tiles and
//     one of padding, five a warp: 1.25x; the dp4a version's 6x30 tiles took
//     1.42x), so that two blocks share an SM.

#include <type_traits>

#include "conv16.cuh"

namespace {

// I and K: CIN -> COUT int8 conv requantised at the mid scale, then the
// align-corners x2 into out (N,2H,2W,COUT). rnum (2,3,H) and cnum (2,3,W)
// int32: the integer numerators of output row 2k+d (column 2l+e) for the
// source taps k-1, k, k+1 (l-1, l, l+1), zero where a tap leaves the image.
// Source tile UH x UW; conv region (UH+2) x RW (the tile and its one-pixel
// ring), starting one pixel above and left of the tile; its halo is two
// rows and columns larger.
constexpr int UW = 32, RW = UW + 2, UHW = RW + 2;

// Geometry and shared-memory layout of the x2 kernel for UH-row tiles:
// weights, scale and bias, the requantised region, the halo ring.
template <int CIN, int COUT, int UH, int STAGES>
struct Up2Layout {
  static constexpr int REG = (UH + 2) * RW, UHH = UH + 4;          // region pixels, halo rows
  static constexpr int MT = (REG + 15) / 16;                       // m16 tiles
  static constexpr int MW = (MT + tc::WARPS - 1) / tc::WARPS;      // a warp's
  static constexpr size_t HALO = (size_t)UHH * UHW * CIN;
  static constexpr size_t OFF_SC = (size_t)9 * COUT * CIN;
  static constexpr size_t OFF_Q = tc::align128(OFF_SC + 2 * COUT * sizeof(float));
  static constexpr size_t OFF_HALO = tc::align128(OFF_Q + (size_t)REG * COUT);
  static constexpr size_t BYTES = OFF_HALO + STAGES * HALO;
};

// The x2 of the requantised region s_q ((UH+2) x RW pixels of COUT int8)
// into the 2UH x 2UW output tile of source tile (sy0, sx0). With VPU the
// tables are float32 (rc, cc of up2_coeffs) and the x2 runs the float chain;
// else int32 numerators and the integer chain.
template <int COUT, bool VPU, int UH>
__device__ __forceinline__ void up2_epilogue(const int8_t* s_q, const void* __restrict__ rtab,
                                             const void* __restrict__ ctab, float inv,
                                             int8_t* __restrict__ out, int n, int sy0, int sx0,
                                             int h, int w) {
  constexpr int CH = COUT / 16;
  const int oh = 2 * h, ow = 2 * w;
  for (int i = threadIdx.x; i < 2 * UH * 2 * UW * CH; i += tc::THREADS) {
    const int c0 = (i % CH) * 16, pix = i / CH;
    const int oy = 2 * sy0 + pix / (2 * UW), ox = 2 * sx0 + pix % (2 * UW);
    if (oy >= oh || ox >= ow) continue;
    const int k = oy >> 1, d = oy & 1, l = ox >> 1, e = ox & 1;
    // tap (t, u) sits at region row k-sy0+t, column l-sx0+u
    const int8_t* base = s_q + ((k - sy0) * RW + (l - sx0)) * COUT + c0;
    int8_t q[16];
    if constexpr (VPU) {
      float rc[3], cc[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        rc[t] = __ldg(static_cast<const float*>(rtab) + (d * 3 + t) * h + k);
        cc[t] = __ldg(static_cast<const float*>(ctab) + (e * 3 + t) * w + l);
      }
      // zero coefficients (every tap that leaves the image among them) are
      // skipped: the TPU chain adds their exact zeros
      float y[16] = {};
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (cc[u] == 0.f) continue;
        float r[16] = {};
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (rc[t] == 0.f) continue;
          int8_t v[16];
          unpack16(v, *reinterpret_cast<const uint4*>(base + (t * RW + u) * COUT));
#pragma unroll
          for (int j = 0; j < 16; ++j)
            r[j] = __fadd_rn(r[j], __fmul_rn(rc[t], __int2float_rn((int)v[j])));
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) y[j] = __fadd_rn(y[j], __fmul_rn(cc[u], r[j]));
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) q[j] = requant(__fmul_rn(y[j], inv), false);
    } else {
      int rn[3], cn[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        rn[t] = __ldg(static_cast<const int*>(rtab) + (d * 3 + t) * h + k);
        cn[t] = __ldg(static_cast<const int*>(ctab) + (e * 3 + t) * w + l);
      }
      int y[16] = {};
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        int r[16] = {};
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          int8_t v[16];
          unpack16(v, *reinterpret_cast<const uint4*>(base + (t * RW + u) * COUT));
#pragma unroll
          for (int j = 0; j < 16; ++j) r[j] += rn[t] * (int)v[j];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) y[j] += cn[u] * r[j];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) q[j] = requant(__fmul_rn(__int2float_rn(y[j]), inv), false);
    }
    store16(out + (((size_t)n * oh + oy) * ow + ox) * COUT + c0, q);
  }
}

// Persistent blocks over the source tiles. The conv's output channels go in
// passes of at most 32 (NW n8 tiles) to bound the accumulators (MW m16 tiles
// x NW x 4 int32 a thread).
template <int CIN, int COUT, bool VPU, int UH, int STAGES, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
conv_up2_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const void* __restrict__ rtab, const void* __restrict__ ctab, float inv,
                    int8_t* __restrict__ out, int n, int h, int w, int relu) {
  using L = Up2Layout<CIN, COUT, UH, STAGES>;
  constexpr int REG = L::REG, UMW = L::MW;
  constexpr int NTOT = COUT / 8, NW = NTOT < 4 ? NTOT : 4, NPASS = NTOT / NW;
  extern __shared__ __align__(128) int8_t tc_smem[];
  int8_t* smem = tc_smem;
  int8_t* s_w = smem;
  float* s_sc = reinterpret_cast<float*>(smem + L::OFF_SC);
  float* s_bi = s_sc + COUT;
  int8_t* s_q = smem + L::OFF_Q;
  const int tiles_x = (w + UW - 1) / UW, per_img = tiles_x * ((h + UH - 1) / UH);
  const int n_tiles = n * per_img;
  auto issue = [&](int t, int stage) {
    if (t < n_tiles) {
      const int img = t / per_img, r = t % per_img;
      tc::load_halo_async<CIN, L::UHH, UHW>(smem + L::OFF_HALO + stage * L::HALO, x, img,
                                            (r / tiles_x) * UH - 2, (r % tiles_x) * UW - 2, h,
                                            w);
    }
    tc::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);
  tc::load_weights_rows<CIN, COUT>(s_w, wt);
  for (int i = threadIdx.x; i < COUT; i += tc::THREADS) {
    s_sc[i] = scale[i];
    s_bi[i] = bias[i];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  int p0[UMW];  // halo pixel of this lane's ldmatrix rows (padding rows read the last pixel)
#pragma unroll
  for (int m = 0; m < UMW; ++m) {
    const int q = min((warp * UMW + m) * 16 + tc::a_row(), REG - 1);
    p0[m] = (q / RW) * UHW + q % RW;
  }
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile's halo is in; the last tile's s_q and halo are free
    issue(t + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES);
    const int8_t* sh = smem + L::OFF_HALO + (it % STAGES) * L::HALO;
#pragma unroll 1
    for (int pass = 0; pass < NPASS; ++pass) {
      int acc[UMW][NW][4] = {};
      tc::conv_mma<CIN, COUT, UHW, UMW, NW>(acc, sh, s_w, p0, pass * NW * 8);
#pragma unroll
      for (int m = 0; m < UMW; ++m)
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int co = pass * NW * 8 + 8 * j + 2 * tq;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int q = (warp * UMW + m) * 16 + g + 8 * hf;
            if (q < REG)
              *reinterpret_cast<uint16_t*>(s_q + q * COUT + co) = tc::pack2(
                  requant(dequant(acc[m][j][2 * hf], s_sc[co], s_bi[co]), relu),
                  requant(dequant(acc[m][j][2 * hf + 1], s_sc[co + 1], s_bi[co + 1]), relu));
          }
        }
    }
    __syncthreads();
    const int img = t / per_img, r = t % per_img;
    up2_epilogue<COUT, VPU, UH>(s_q, rtab, ctab, inv, out, img, (r / tiles_x) * UH,
                                (r % tiles_x) * UW, h, w);
  }
  tc::cp_async_wait<0>();
}

// J and L: conv(concat(x, z)) = conv(x, wx)*sx + conv(z, wz)*sz + bias,
// C + C -> C, requant(relu(...)) with the dp4a version's roundings: each
// product rounded, their sum rounded, then + bias rounded. DTH x DTW output
// tiles; warp w takes tile row w.
constexpr int DTH = 8, DTW = 32;

template <int C, int STAGES>
struct DualLayout {
  static constexpr int HH = DTH + 2, HWD = DTW + 2;
  static constexpr size_t HALO = (size_t)HH * HWD * C;  // one input's
  static constexpr size_t OFF_WZ = (size_t)9 * C * C;
  static constexpr size_t OFF_SC = 2 * OFF_WZ;
  static constexpr size_t OFF_OUT = tc::align128(OFF_SC + 3 * C * sizeof(float));
  static constexpr size_t OFF_HALO = OFF_OUT + (size_t)tc::WARPS * DTW * C;
  static constexpr size_t BYTES = OFF_HALO + STAGES * 2 * HALO;
};

template <int C, int STAGES, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
conv_dual_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ z,
                     const int8_t* __restrict__ wx, const int8_t* __restrict__ wz,
                     const float* __restrict__ sx, const float* __restrict__ sz,
                     const float* __restrict__ bias, int8_t* __restrict__ out, int n, int h,
                     int w, int relu) {
  using L = DualLayout<C, STAGES>;
  constexpr int CH = C / 16, NT8 = C / 8;
  extern __shared__ __align__(128) int8_t tc_smem[];
  int8_t* smem = tc_smem;
  int8_t* s_wx = smem;
  int8_t* s_wz = smem + L::OFF_WZ;
  float* s_sx = reinterpret_cast<float*>(smem + L::OFF_SC);
  float* s_sz = s_sx + C;
  float* s_b = s_sz + C;
  const int tiles_x = (w + DTW - 1) / DTW, per_img = tiles_x * ((h + DTH - 1) / DTH);
  const int n_tiles = n * per_img;
  auto issue = [&](int t, int stage) {
    if (t < n_tiles) {
      const int img = t / per_img, r = t % per_img;
      const int y0 = (r / tiles_x) * DTH - 1, x0 = (r % tiles_x) * DTW - 1;
      int8_t* sh = smem + L::OFF_HALO + stage * 2 * L::HALO;
      tc::load_halo_async<C, L::HH, L::HWD>(sh, x, img, y0, x0, h, w);
      tc::load_halo_async<C, L::HH, L::HWD>(sh + L::HALO, z, img, y0, x0, h, w);
    }
    tc::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);
  tc::load_weights_rows<C, C>(s_wx, wx);
  tc::load_weights_rows<C, C>(s_wz, wz);
  for (int i = threadIdx.x; i < C; i += tc::THREADS) {
    s_sx[i] = sx[i];
    s_sz[i] = sz[i];
    s_b[i] = bias[i];
  }
  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int p0[2] = {row * L::HWD + tc::a_row(), row * L::HWD + 16 + tc::a_row()};
  int8_t* s_o = smem + L::OFF_OUT + row * DTW * C;  // this warp's output row, swizzled
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile's halos are in; the last tile's stage is free
    issue(t + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES);
    const int8_t* sh = smem + L::OFF_HALO + (it % STAGES) * 2 * L::HALO;
    int ax[2][NT8][4] = {}, az[2][NT8][4] = {};
    tc::conv_mma<C, C, L::HWD, 2, NT8>(ax, sh, s_wx, p0, 0);
    tc::conv_mma<C, C, L::HWD, 2, NT8>(az, sh + L::HALO, s_wz, p0, 0);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int co = 8 * j + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int8_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float yx = __fmul_rn(__int2float_rn(ax[m][j][2 * hf + e]), s_sx[co + e]);
            const float yz = __fmul_rn(__int2float_rn(az[m][j][2 * hf + e]), s_sz[co + e]);
            q[e] = requant(__fadd_rn(__fadd_rn(yx, yz), s_b[co + e]), relu);
          }
          const int pix = 16 * m + g + 8 * hf;
          *reinterpret_cast<uint16_t*>(s_o + tc::swz<CH>(pix, co / 16) * 16 + co % 16) =
              tc::pack2(q[0], q[1]);
        }
      }
    __syncwarp();
    const int img = t / per_img, r = t % per_img;
    const int gy = (r / tiles_x) * DTH + row, x0 = (r % tiles_x) * DTW;
    if (gy < h) {
      for (int k = lane; k < DTW * CH; k += 32) {
        const int pix = k / CH, c = k % CH;
        if (x0 + pix < w)
          *reinterpret_cast<uint4*>(out + (((size_t)img * h + gy) * w + x0 + pix) * C + c * 16) =
              *reinterpret_cast<const uint4*>(s_o + tc::swz<CH>(pix, c) * 16);
      }
    }
  }
  tc::cp_async_wait<0>();
}

// G at db2 and db3 (32 -> 32 and 64 -> 64, with or without the residual
// add) and H at db2 (32 -> 64 with the 2x2 pool): one input on the k32 loop
// of conv_mma.cuh. TH x 32 output tiles, walked in units of two rows by 16
// columns (two m16 tiles, one a row; unit u: rows 2 (u / 2) + 0..1, columns
// 16 (u % 2) + 0..15), TH / 8 units a warp. So the vertical pair of a pool
// cell sits in one lane (pixel g of tiles m = 0 and 1) and the horizontal
// pair in lanes 4g + tq and 4(g + 1) + tq, one shuffle apart: the pool needs
// no block barrier and sums the requantised int8 in int32. A 32- or
// 64-channel accumulator passes 2^22 (9 * 64 * 127^2 = 9,290,304 < 2^24), so
// these epilogues convert with __int2float_rn (exact there); requant_bits
// clips first and holds at any width.
struct ProwArgs {
  const int8_t* x;
  const int8_t* wt;
  const float* scale;
  const float* bias;
  const int8_t* res;  // G's res.conv2, or NULL
  float res_sc;
  int8_t* out;
  int8_t* pool;  // H
  float pool_sc;
  int n, h, w, relu;
};

constexpr int PTW = 32;  // tile width
constexpr int UPX = 32;  // pixels a unit

// Shared memory: the weights as load_weights_rows' rows, scale and bias, the
// requantised output tile (each warp's units; swizzled rows of COUT bytes,
// the residual staged there first), each warp's pool cells, the halo ring.
template <int CIN, int COUT, bool POOL, int TH, int STAGES>
struct ProwLayout {
  static constexpr int HH = TH + 2, HWD = PTW + 2;
  static constexpr size_t HALO = (size_t)HH * HWD * CIN;
  static constexpr size_t OFF_SC = (size_t)9 * COUT * CIN;
  static constexpr size_t OFF_OUT = tc::align128(OFF_SC + 2 * COUT * sizeof(float));
  static constexpr size_t OFF_POOL = OFF_OUT + (size_t)TH * PTW * COUT;
  static constexpr size_t OFF_HALO = OFF_POOL + (POOL ? (size_t)tc::WARPS * 8 * COUT : 0);
  static constexpr size_t BYTES = OFF_HALO + STAGES * HALO;
};

template <int CIN, int COUT, bool RES, bool POOL, int TH, int STAGES, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
conv_prow_mma_kernel(const ProwArgs a) {
  using L = ProwLayout<CIN, COUT, POOL, TH, STAGES>;
  constexpr int CH = COUT / 16, NT8 = COUT / 8, UPW = TH / tc::WARPS;  // units a warp
  static_assert(TH % tc::WARPS == 0, "whole units a warp");
  extern __shared__ __align__(128) int8_t tc_smem[];
  int8_t* smem = tc_smem;
  float* s_sc = reinterpret_cast<float*>(smem + L::OFF_SC);
  float* s_b = s_sc + COUT;
  const int h = a.h, w = a.w;
  const int tiles_x = (w + PTW - 1) / PTW, per_img = tiles_x * ((h + TH - 1) / TH);
  const int n_tiles = a.n * per_img;
  auto issue = [&](int t, int stage) {
    if (t < n_tiles) {
      const int img = t / per_img, r = t % per_img;
      tc::load_halo_async<CIN, L::HH, L::HWD>(smem + L::OFF_HALO + stage * L::HALO, a.x, img,
                                              (r / tiles_x) * TH - 1, (r % tiles_x) * PTW - 1,
                                              h, w);
    }
    tc::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);
  tc::load_weights_rows<CIN, COUT>(smem, a.wt);
  for (int i = threadIdx.x; i < COUT; i += tc::THREADS) {
    s_sc[i] = a.scale[i];
    s_b[i] = a.bias[i];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  int8_t* s_o = smem + L::OFF_OUT + warp * UPW * UPX * COUT;  // this warp's units
  int8_t* s_p = smem + L::OFF_POOL + warp * 8 * COUT;         // one unit's 8 pool cells
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile's halo is in; the last tile's stage and s_o are free
    const int img = t / per_img, rt = t % per_img;
    const int ty0 = (rt / tiles_x) * TH, tx0 = (rt % tiles_x) * PTW;
    if constexpr (RES) {
      // the residual of this warp's units into s_o (pixel k of a unit: row
      // k / 16, column k % 16), read back by each lane's epilogue from the
      // bytes it then overwrites; past the ragged edge the clamped pixel
      // stands in (its output is not stored)
      const uint32_t so = tc::smem_u32(s_o);
      for (int k = lane; k < UPW * UPX * CH; k += 32) {
        const int c = k % CH, px = k / CH, u = warp * UPW + px / UPX, q = px % UPX;
        const int gy = min(ty0 + 2 * (u / 2) + q / 16, h - 1);
        const int gx = min(tx0 + 16 * (u % 2) + q % 16, w - 1);
        tc::cp_async16(so + tc::swz<CH>(px, c) * 16,
                       a.res + (((size_t)img * h + gy) * w + gx) * COUT + c * 16);
      }
      tc::cp_async_commit();
    }
    issue(t + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES);
    const int8_t* sh = smem + L::OFF_HALO + (it % STAGES) * L::HALO;
#pragma unroll 1
    for (int v = 0; v < UPW; ++v) {
      const int u = warp * UPW + v, y0 = ty0 + 2 * (u / 2), x0 = tx0 + 16 * (u % 2);
      const int hp = 2 * (u / 2) * L::HWD + 16 * (u % 2) + tc::a_row();
      const int p0[2] = {hp, hp + L::HWD};
      int acc[2][NT8][4] = {};
      tc::conv_mma<CIN, COUT, L::HWD, 2, NT8>(acc, sh, smem, p0, 0);
      if constexpr (RES) {
        if (v == 0) {
          tc::cp_async_wait<1>();  // the residual; the halo issued after it may still fly
          __syncwarp();
        }
      }
      int8_t* so = s_o + v * UPX * COUT;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int co = 8 * j + 2 * tq;
        // read before the stores below, which the compiler cannot tell apart
        const float sc[2] = {s_sc[co], s_sc[co + 1]}, bi[2] = {s_b[co], s_b[co + 1]};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int sum[2] = {0, 0};  // of the cell's vertical pair
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint16_t* dst = reinterpret_cast<uint16_t*>(
                so + tc::swz<CH>(16 * m + g + 8 * hf, co / 16) * 16 + co % 16);
            uint32_t v0 = 0;
            if constexpr (RES) v0 = *dst;
            uint32_t q[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float y = dequant(acc[m][j][2 * hf + e], sc[e], bi[e]);
              if constexpr (RES) {
                if (a.relu) y = fmaxf(y, 0.f);
                const int r0 = (int8_t)(v0 >> (8 * e));
                q[e] = tc::requant_bits(__fadd_rn(__fmul_rn(tc::i2f_small(r0), a.res_sc), y),
                                        false);
              } else {
                q[e] = tc::requant_bits(y, a.relu);
              }
              if constexpr (POOL) sum[e] += (int8_t)q[e];
            }
            *dst = (uint16_t)__byte_perm(q[0], q[1], 0x0040);
          }
          if constexpr (POOL) {
            uint32_t p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int sum4 = sum[e] + __shfl_xor_sync(0xffffffffu, sum[e], 4);
              p[e] = tc::requant_bits(__fmul_rn(tc::i2f_small(sum4), a.pool_sc), false);
            }
            if ((g & 1) == 0)  // cell (g + 8hf) / 2 of the unit's 8
              *reinterpret_cast<uint16_t*>(s_p + tc::swz<CH>(g / 2 + 4 * hf, co / 16) * 16 +
                                           co % 16) = (uint16_t)__byte_perm(p[0], p[1], 0x0040);
          }
        }
      }
      __syncwarp();
      for (int k = lane; k < UPX * CH; k += 32) {
        const int c = k % CH, px = k / CH, gy = y0 + px / 16, gx = x0 + px % 16;
        if (gy < h && gx < w)
          *reinterpret_cast<uint4*>(a.out + (((size_t)img * h + gy) * w + gx) * COUT + c * 16) =
              *reinterpret_cast<const uint4*>(so + tc::swz<CH>(px, c) * 16);
      }
      if constexpr (POOL) {
        // y0 and x0 are even; cells past the ragged edge write nothing
        const int gpy = y0 / 2;
        for (int k = lane; k < 8 * CH; k += 32) {
          const int c = k % CH, gpx = x0 / 2 + k / CH;
          if (gpy < h / 2 && gpx < w / 2)
            *reinterpret_cast<uint4*>(a.pool + (((size_t)img * (h / 2) + gpy) * (w / 2) + gpx) *
                                                   COUT + c * 16) =
                *reinterpret_cast<const uint4*>(s_p + tc::swz<CH>(k / CH, c) * 16);
        }
        __syncwarp();  // s_p is the next unit's
      }
    }
  }
  tc::cp_async_wait<0>();
}

constexpr int RING = 2;  // halo stages of the tensor-core kernels

// Blocks an SM holds (__launch_bounds__ caps the registers for them): two
// wherever shared memory leaves room, which J at 64 channels (178 KB) does
// not. I takes 8-row source tiles so that two of its blocks fit (115 and
// 85 KB), K 16-row ones. On the H100 one block an SM with 16-row tiles for
// I ran I up to 17 %, J at 32 channels about 30 % and K about 20 % slower
// (the one_block variant of kernels/tc_variants.py).
constexpr int dual_min_blocks(int c) { return c == 64 ? 1 : 2; }
constexpr int up2_rows(int cin) { return cin == 64 ? 8 : 16; }
constexpr int UP2_MIN_BLOCKS = 2;

// What a tensor-core entry launches for a shape: the kernel instantiation,
// its shared memory a block and the tiles its persistent blocks walk. The
// launch and the shape query (sifsr_conv_mma_shape) both read it here.
template <int CIN, int COUT, bool VPU>
struct Up2Entry {
  static constexpr int UH = up2_rows(CIN);
  static constexpr size_t SMEM = Up2Layout<CIN, COUT, UH, RING>::BYTES;
  static auto kernel() {
    return conv_up2_mma_kernel<CIN, COUT, VPU, UH, RING, UP2_MIN_BLOCKS>;
  }
  static int tiles(int n, int h, int w) {
    return n * ((h + UH - 1) / UH) * ((w + UW - 1) / UW);
  }
};

template <int C>
struct DualEntry {
  static constexpr size_t SMEM = DualLayout<C, RING>::BYTES;
  static auto kernel() { return conv_dual_mma_kernel<C, RING, dual_min_blocks(C)>; }
  static int tiles(int n, int h, int w) {
    return n * ((h + DTH - 1) / DTH) * ((w + DTW - 1) / DTW);
  }
};

// G and H at db1 (16 channels in, 128²): the 16-channel kernel of
// conv16.cuh on B's tiling (32-row tiles, three halo stages), three blocks
// an SM for G, two for H's 32 output channels (36 weight registers a lane).
// On the H100 16-row tiles ran G 1-11 % slower and H 1-2 %, a fourth stage
// 1-6 % slower (kernels/tc_variants.py: prow_rows, prow_ring).
constexpr int PROW16_ROWS = 32;
constexpr int PROW16_RING = 3;
constexpr int prow16_min_blocks(int cout) { return cout == 16 ? 3 : 2; }

template <int COUT, bool PM, bool RES>
using Prow16Entry = tc::Conv16Entry<1, COUT, PM, RES, PROW16_ROWS, 1, PROW16_RING,
                                    prow16_min_blocks(COUT)>;

// G and H at db2 and db3 (32 and 64 channels in): conv_prow_mma_kernel on
// 16x32 tiles for G at 32 channels (two units a warp), 8x32 ones elsewhere
// (H at 16 rows spills 148 B at the register cap, for no gain), two halo
// stages, the register cap of two blocks an SM (one where their shared
// memory leaves no room for two). Chosen on the H100 by kernels/tc_variants.py:
// the other heights (prow_rows) ran G 1-8 % slower at 32 channels and 0-11 %
// at 64, more stages (prow_ring) 2-15 % slower, three blocks an SM at 32
// channels (prow_blocks) 8-19 % slower.
constexpr int prow_rows(int cin, int cout) { return cin == 32 && cout == 32 ? 16 : 8; }
constexpr int prow_ring(int) { return 2; }
constexpr int prow_blocks(int) { return 2; }

template <int CIN, int COUT, bool RES, bool POOL>
struct ProwEntry {
  static constexpr int TH = prow_rows(CIN, COUT), STAGES = prow_ring(CIN);
  static constexpr size_t SMEM = ProwLayout<CIN, COUT, POOL, TH, STAGES>::BYTES;
  static constexpr int FIT = (int)(233472 / (SMEM + 1024));  // blocks an SM's shared memory holds
  static constexpr int MINB = prow_blocks(CIN) < FIT ? prow_blocks(CIN) : FIT;
  static auto kernel() { return conv_prow_mma_kernel<CIN, COUT, RES, POOL, TH, STAGES, MINB>; }
  static int tiles(int n, int h, int w) {
    return n * ((h + TH - 1) / TH) * ((w + PTW - 1) / PTW);
  }
  static int launch(const ProwArgs& a, cudaStream_t s) {
    return tc::launch_persistent(kernel(), SMEM, tiles(a.n, a.h, a.w), s, a);
  }
};

// The entry of kernel G (conv_prow, RES: with the residual) or H
// (conv_prow_split_pool: POOL) for CIN -> COUT.
template <int CIN, int COUT, bool RES, bool POOL>
using GHEntry = std::conditional_t<CIN == 16, Prow16Entry<COUT, POOL, RES>,
                                   ProwEntry<CIN, COUT, RES, POOL>>;

template <int CIN, int COUT, bool RES, bool POOL>
int launch_gh(const void* x, const void* wt, const void* scale, const void* bias,
              const void* res, float res_sc, void* out, void* pool, float pool_sc, int n, int h,
              int w, int relu, cudaStream_t s) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wt);
  const auto* sp = static_cast<const float*>(scale);
  const auto* bp = static_cast<const float*>(bias);
  const auto* rp = static_cast<const int8_t*>(res);
  if constexpr (CIN == 16) {
    const tc::Conv16Args<1> a{{xp}, {wp}, {sp}, bp, static_cast<int8_t*>(out),
                              static_cast<int8_t*>(pool), pool_sc, rp, res_sc, n, h, w, relu};
    return GHEntry<CIN, COUT, RES, POOL>::launch(a, s);
  } else {
    const ProwArgs a{xp, wp, sp, bp, rp, res_sc, static_cast<int8_t*>(out),
                     static_cast<int8_t*>(pool), pool_sc, n, h, w, relu};
    return GHEntry<CIN, COUT, RES, POOL>::launch(a, s);
  }
}

template <int CIN, int COUT, bool VPU>
int launch_up2(const void* x, const void* wt, const void* scale, const void* bias,
               const void* rtab, const void* ctab, float inv, void* out, int n, int h, int w,
               int relu, cudaStream_t s) {
  using E = Up2Entry<CIN, COUT, VPU>;
  return tc::launch_persistent(E::kernel(), E::SMEM, E::tiles(n, h, w), s,
                               static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                               static_cast<const float*>(scale), static_cast<const float*>(bias),
                               rtab, ctab, inv, static_cast<int8_t*>(out), n, h, w, relu);
}

template <int C>
int launch_dual_mma(const void* x, const void* z, const void* wx, const void* wz,
                    const void* sx, const void* sz, const void* bias, void* out, int n, int h,
                    int w, int relu, cudaStream_t s) {
  using E = DualEntry<C>;
  return tc::launch_persistent(E::kernel(), E::SMEM, E::tiles(n, h, w), s,
                               static_cast<const int8_t*>(x), static_cast<const int8_t*>(z),
                               static_cast<const int8_t*>(wx), static_cast<const int8_t*>(wz),
                               static_cast<const float*>(sx), static_cast<const float*>(sz),
                               static_cast<const float*>(bias), static_cast<int8_t*>(out), n, h,
                               w, relu);
}

}  // namespace

extern "C" {

const char* sifsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// (cin, cout) pairs each entry point is built for: the ModelB2 mid chain.
#define SIFSR_PROW_SHAPES(X) X(16, 16) X(32, 32) X(64, 64)
#define SIFSR_POOL_SHAPES(X) X(16, 32) X(32, 64)
#define SIFSR_UP2_SHAPES(X) X(64, 64) X(64, 32) X(32, 16)

// x (N,H,W,CIN) int8 -> out (N,H,W,COUT) int8; res (N,H,W,COUT) int8 or NULL.
int sifsr_conv_prow(const void* x, const void* wt, const void* scale, const void* bias,
                    const void* res, float res_sc, void* out, int n, int h, int w, int cin,
                    int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFSR_CASE(CI, CO)                                                                  \
  if (cin == CI && cout == CO)                                                              \
    return res ? launch_gh<CI, CO, true, false>(x, wt, scale, bias, res, res_sc, out, nullptr,    \
                                                0.f, n, h, w, relu, s)                          \
               : launch_gh<CI, CO, false, false>(x, wt, scale, bias, nullptr, 0.f, out,         \
                                                 nullptr, 0.f, n, h, w, relu, s);
  SIFSR_PROW_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

// x (N,H,W,CIN) -> out (N,H,W,COUT) and pool (N,H/2,W/2,COUT), H and W even.
int sifsr_conv_prow_split_pool(const void* x, const void* wt, const void* scale,
                               const void* bias, void* out, void* pool, float pool_sc, int n,
                               int h, int w, int cin, int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFSR_CASE(CI, CO)                                                                  \
  if (cin == CI && cout == CO)                                                              \
    return launch_gh<CI, CO, false, true>(x, wt, scale, bias, nullptr, 0.f, out, pool, pool_sc, \
                                          n, h, w, relu, s);
  SIFSR_POOL_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

// x (N,H,W,CIN) -> out (N,2H,2W,COUT); rnum (2,3,H), cnum (2,3,W) int32.
int sifsr_conv_prow_up2(const void* x, const void* wt, const void* scale, const void* bias,
                        const void* rnum, const void* cnum, float inv, void* out, int n, int h,
                        int w, int cin, int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFSR_CASE(CI, CO)                                                                  \
  if (cin == CI && cout == CO)                                                              \
    return launch_up2<CI, CO, false>(x, wt, scale, bias, rnum, cnum, inv, out, n, h, w,    \
                                     relu, s);
  SIFSR_UP2_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

// The same with the float32 chain: rc (2,3,H), cc (2,3,W) float32.
int sifsr_conv_prow_up2_vpu(const void* x, const void* wt, const void* scale, const void* bias,
                            const void* rc, const void* cc, float inv, void* out, int n, int h,
                            int w, int cin, int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFSR_CASE(CI, CO)                                                                  \
  if (cin == CI && cout == CO)                                                              \
    return launch_up2<CI, CO, true>(x, wt, scale, bias, rc, cc, inv, out, n, h, w, relu, s);
  SIFSR_UP2_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

// x, z (N,H,W,C) -> out (N,H,W,C), C 32 or 64.
int sifsr_conv_prow_dual(const void* x, const void* z, const void* wx, const void* wz,
                         const void* sx, const void* sz, const void* bias, void* out, int n,
                         int h, int w, int c, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 32) return launch_dual_mma<32>(x, z, wx, wz, sx, sz, bias, out, n, h, w, relu, s);
  if (c == 64) return launch_dual_mma<64>(x, z, wx, wz, sx, sz, bias, out, n, h, w, relu, s);
  return (int)cudaErrorInvalidValue;
}

// The launch of a tensor-core entry for the given shape, without launching:
// kind 0 sifsr_conv_prow_dual (cin == cout == C), 1 sifsr_conv_prow_up2,
// 2 sifsr_conv_prow_up2_vpu, 3 sifsr_conv_prow without and 4 with the
// residual, 5 sifsr_conv_prow_split_pool. Writes the persistent grid (blocks), the
// dynamic shared memory of a block in bytes and the number of tiles.
int sifsr_conv_mma_shape(int kind, int cin, int cout, int n, int h, int w, int* blocks,
                         int* smem, int* tiles) {
  if (kind == 0 && cin == 32 && cout == 32)
    return tc::entry_shape<DualEntry<32>>(n, h, w, blocks, smem, tiles);
  if (kind == 0 && cin == 64 && cout == 64)
    return tc::entry_shape<DualEntry<64>>(n, h, w, blocks, smem, tiles);
#define SIFSR_CASE(CI, CO)                                                                  \
  if (kind == 1 && cin == CI && cout == CO)                                                 \
    return tc::entry_shape<Up2Entry<CI, CO, false>>(n, h, w, blocks, smem, tiles);              \
  if (kind == 2 && cin == CI && cout == CO)                                                 \
    return tc::entry_shape<Up2Entry<CI, CO, true>>(n, h, w, blocks, smem, tiles);
  SIFSR_UP2_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
#define SIFSR_CASE(CI, CO)                                                                  \
  if (kind == 3 && cin == CI && cout == CO)                                                 \
    return tc::entry_shape<GHEntry<CI, CO, false, false>>(n, h, w, blocks, smem, tiles);    \
  if (kind == 4 && cin == CI && cout == CO)                                                 \
    return tc::entry_shape<GHEntry<CI, CO, true, false>>(n, h, w, blocks, smem, tiles);
  SIFSR_PROW_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
#define SIFSR_CASE(CI, CO)                                                                  \
  if (kind == 5 && cin == CI && cout == CO)                                                 \
    return tc::entry_shape<GHEntry<CI, CO, false, true>>(n, h, w, blocks, smem, tiles);
  SIFSR_POOL_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
