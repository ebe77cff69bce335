// Replicate-padded 3x3 int8 convolutions on NHWC tensors, int32 accumulate,
// float32 dequantise epilogue.
//
// Replaces, from sifsr_tpu/pallas/conv_i8.py:
//   conv_i8_exact      (pl.pallas_call at conv_i8.py:358 and :375; entry
//                       sifsr_conv_i8_exact, with the fused 2x2 phase mean)
//   conv_i8_exact_dual (conv_i8.py:408; entry sifsr_conv_i8_exact_dual)
//   conv_i8_in1_split  (conv_i8.py:755; entry sifsr_conv_i8_in1_split)
//   conv_i8_in1        (conv_i8.py:623; entry sifsr_conv_i8_in1: the same
//                       kernel reading one channel-interleaved (N,H,W,2) input)
//   conv_i8_outlay     (conv_i8.py:484; entry sifsr_conv_i8_outlay: 16 -> 1
//                       with the dequantise + Kelvin de-normalise epilogue
//                       y = acc * scale + bias in float32, no requantise)
// and runs the XLA int8 mid chain / outlay conv of
// sifsr_tpu/models/quantized_packed.py:66-107 and pallas_serving.py:494
// (entry sifsr_conv_i8_generic; F.conv2d has no integer path on CUDA).
//
// The TPU kernels work in a 2x2 space-to-depth packed domain with pixel-pair
// rows and lane permutations, all of it to fill 128 TPU lanes. That packed
// conv equals the plain replicate-pad conv on the unpacked tensor, so these
// kernels work on unpacked NHWC int8 (256x256x16 at serving size) and keep
// only the function: int32 sums, then per output channel
//   y = acc * scale + bias        (two roundings: __fmul_rn, __fadd_rn)
//   [ReLU] -> rint (half-to-even) -> clip [-127, 127] -> int8
// (the dual form sums acc_x*scale_x + acc_z*scale_z before the bias, as the
// Pallas kernel does; the phase mean is rint(sum4 * pm_scale), the int32
// 2x2 sum of the requantised output times float32 phase_mean/4).
//
// Bound on the H100: memory at the serving shapes (about 1 MB of int8 in
// and out per 256x256x16 image against ~38 M int8 multiply-adds, far below
// the card's int8 rate).
//
// B and C run on the int8 tensor cores (the 16-channel tap-pair loop of
// conv_mma.cuh, conv16_mma_kernel below): the dp4a loop they had before took
// 576 dp4a a pixel for B, ~0.8 ms of the INT32 pipe a call at batch 324
// against ~0.21 ms of bytes. Persistent blocks keep the weights in registers
// and stream 32x32 (B) or 16x32 (C) output tiles through a three-stage
// cp.async halo ring; each warp takes consecutive tile rows (four or two),
// one 32-pixel row (two m16 tiles) at a time, stages the requantised bytes
// in shared memory and writes them as coalesced 16-byte stores, and B's
// phase mean pools the 2x2 cells of its own row pairs. The epilogue's
// conversions go on the float and integer pipes (i2f_small, requant_bits:
// the same values as __int2float_rn and rintf), since Hopper converts 16
// values a clock an SM and each output takes two or three conversions (three
// for C) otherwise.
//
// D, E, F and the generic conv keep the 8x32-tile dp4a main loop of
// conv_tile.cuh (halo and weights in shared memory, one thread per output
// pixel and all its channels); each tensor is read once from device memory
// and written once, outputs as 16-byte stores. The outlay kernel reads 16
// bytes and writes 4 per pixel for 144 multiply-adds: one thread per output
// pixel, float32 stores coalesced along the image row (the TPU form's
// 8-useful-lane output and the transpose after it do not exist here).

#include "conv_mma.cuh"

namespace {

// B and C: NIN 16-channel int8 inputs (B one, C two: conv(concat(x, z)) as
// two convs whose concat is never formed), each with its weights (HWIO
// (3,3,16,16)), dequantise scale and int32 accumulators; 16 int8 outputs
//   requant(acc_0*scale_0 [+ acc_1*scale_1] + bias)
// each product rounded, their sum rounded, then + bias rounded (one input:
// dequant of conv_tile.cuh). With PM (B as inbloc.conv2) also the phase
// mean into pm (N, H/2, W/2, 16): rint(float(int32 sum of the requantised
// 2x2 cell) * pm_scale), clipped.
template <int NIN>
struct Conv16Args {
  const int8_t* x[NIN];
  const int8_t* wt[NIN];
  const float* scale[NIN];
  const float* bias;
  int8_t* out;
  int8_t* pm;
  float pm_scale;
  int n, h, w, relu;
};

constexpr int C16_TW = 32;  // tile width: two m16 tiles a row

// Shared memory: the requantised output tile, then STAGES halo stages of
// NIN inputs each.
template <int NIN, int TH, int STAGES>
struct Conv16Layout {
  static constexpr int HH = TH + 2, HWD = C16_TW + 2;
  static constexpr size_t HALO = (size_t)HH * HWD * 16;  // one input's
  static constexpr size_t OFF_HALO = (size_t)TH * C16_TW * 16;
  static constexpr size_t BYTES = OFF_HALO + (size_t)STAGES * NIN * HALO;
};

// TH-row tiles, RPP of a warp's rows at a time (2 * RPP m16 tiles).
template <int NIN, bool PM, int TH, int RPP, int STAGES, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
conv16_mma_kernel(const Conv16Args<NIN> a) {
  using L = Conv16Layout<NIN, TH, STAGES>;
  constexpr int RPW = TH / tc::WARPS, MT = 2 * RPP;  // tile rows a warp, m16 tiles a pass
  static_assert(TH % tc::WARPS == 0 && RPW % RPP == 0 && (!PM || RPW % 2 == 0),
                "whole rows a warp and a pass, and row pairs for the phase mean");
  extern __shared__ __align__(128) int8_t tc_smem[];
  const int h = a.h, w = a.w;
  const int tiles_x = (w + C16_TW - 1) / C16_TW, per_img = tiles_x * ((h + TH - 1) / TH);
  const int n_tiles = a.n * per_img;
  auto issue = [&](int t, int stage) {
    if (t < n_tiles) {
      const int img = t / per_img, r = t % per_img;
      const int y0 = (r / tiles_x) * TH - 1, x0 = (r % tiles_x) * C16_TW - 1;
#pragma unroll
      for (int i = 0; i < NIN; ++i)
        tc::load_halo_async<16, L::HH, L::HWD>(
            tc_smem + L::OFF_HALO + (stage * NIN + i) * L::HALO, a.x[i], img, y0, x0, h, w);
    }
    tc::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  tc::W16Frags<2> wf[NIN];
  float sc[NIN][2][2], bi[2][2];  // of this lane's channels 8j + 2tq + e
#pragma unroll
  for (int i = 0; i < NIN; ++i) tc::load_w16(wf[i], a.wt[i]);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bi[j][e] = __ldg(a.bias + 8 * j + 2 * tq + e);
#pragma unroll
      for (int i = 0; i < NIN; ++i) sc[i][j][e] = __ldg(a.scale[i] + 8 * j + 2 * tq + e);
    }
  int8_t* s_o = tc_smem + warp * RPW * C16_TW * 16;  // this warp's rows of the output tile
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile's halos are in; the last tile's stage is free
    issue(t + (STAGES - 1) * gridDim.x, (it + STAGES - 1) % STAGES);
    const int8_t* sh = tc_smem + L::OFF_HALO + (it % STAGES) * NIN * L::HALO;
#pragma unroll 1
    for (int r = 0; r < RPW; r += RPP) {
      int p0[MT];  // m16 tile m: row r + m / 2 of the warp's, pixels 16 (m % 2) + 0..15
#pragma unroll
      for (int m = 0; m < MT; ++m)
        p0[m] = (warp * RPW + r + m / 2) * L::HWD + 16 * (m % 2) + tc::a_row();
      int acc[NIN][MT][2][4] = {};
#pragma unroll
      for (int i = 0; i < NIN; ++i)
        tc::conv16_mma<L::HWD, MT, 2>(acc[i], sh + i * L::HALO, wf[i], p0);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t q[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float y = __fmul_rn(tc::i2f_small(acc[0][m][j][2 * hf + e]), sc[0][j][e]);
#pragma unroll
              for (int i = 1; i < NIN; ++i)
                y = __fadd_rn(y, __fmul_rn(tc::i2f_small(acc[i][m][j][2 * hf + e]), sc[i][j][e]));
              q[e] = tc::requant_bits(__fadd_rn(y, bi[j][e]), a.relu);
            }
            const int pix = (r + m / 2) * C16_TW + 16 * (m % 2) + g + 8 * hf;
            *reinterpret_cast<uint16_t*>(s_o + pix * 16 + 8 * j + 2 * tq) =
                (uint16_t)__byte_perm(q[0], q[1], 0x0040);
          }
    }
    __syncwarp();
    const int img = t / per_img, rt = t % per_img;
    const int y0 = (rt / tiles_x) * TH + warp * RPW, x0 = (rt % tiles_x) * C16_TW;
    for (int k = lane; k < RPW * C16_TW; k += 32) {
      const int gy = y0 + k / C16_TW, gx = x0 + k % C16_TW;
      if (gy < h && gx < w)
        *reinterpret_cast<uint4*>(a.out + (((size_t)img * h + gy) * w + gx) * 16) =
            *reinterpret_cast<const uint4*>(s_o + k * 16);
    }
    if constexpr (PM) {
      // the 2x2 cells of this warp's row pairs (y0 and x0 are even); cells
      // past the ragged edge write nothing
      for (int k = lane; k < RPW / 2 * C16_TW / 2; k += 32) {
        const int pr = k / (C16_TW / 2), px = k % (C16_TW / 2);
        const int gpy = y0 / 2 + pr, gpx = x0 / 2 + px;
        if (gpy >= h / 2 || gpx >= w / 2) continue;
        const int8_t* c = s_o + (2 * pr * C16_TW + 2 * px) * 16;
        int8_t a0[16], a1[16], b0[16], b1[16], p[16];
        unpack16(a0, *reinterpret_cast<const uint4*>(c));
        unpack16(a1, *reinterpret_cast<const uint4*>(c + 16));
        unpack16(b0, *reinterpret_cast<const uint4*>(c + C16_TW * 16));
        unpack16(b1, *reinterpret_cast<const uint4*>(c + C16_TW * 16 + 16));
#pragma unroll
        for (int co = 0; co < 16; ++co) {
          const int sum4 = (int)a0[co] + (int)a1[co] + (int)b0[co] + (int)b1[co];
          p[co] = (int8_t)tc::requant_bits(__fmul_rn(tc::i2f_small(sum4), a.pm_scale), false);
        }
        store16(a.pm + (((size_t)img * (h / 2) + gpy) * (w / 2) + gpx) * 16, p);
      }
    }
  }
  tc::cp_async_wait<0>();
}

// The launch of B and C: tiles of 32 rows for B (four a warp) and 16 for C
// (two a warp; the phase mean needs row pairs), three halo stages, the
// register cap of 3 (B) or 2 (C) blocks an SM. Chosen on the H100 by
// kernels/tc_variants.py: the other heights (c16_rows) ran B 6-30 % and C
// 10-16 % slower (at 32 rows C's 127 KB of shared memory leave one block an
// SM); a fourth stage (c16_ring4) was up to 9 % slower, two rows a pass
// (c16_two_rows) within noise, the conversion-unit epilogue (cvt) 9-27 %
// slower.
constexpr int c16_rows(int nin) { return nin == 1 ? 32 : 16; }
constexpr int c16_rows_a_pass(int) { return 1; }
constexpr int C16_RING = 3;
constexpr int c16_min_blocks(int nin) { return nin == 1 ? 3 : 2; }

// What an entry launches for a shape (the launch and the shape query
// sifsr_conv_i8_mma_shape both read it here).
template <int NIN, bool PM>
struct Conv16Entry {
  static constexpr int ROWS = c16_rows(NIN);
  static constexpr size_t SMEM = Conv16Layout<NIN, ROWS, C16_RING>::BYTES;
  static auto kernel() {
    return conv16_mma_kernel<NIN, PM, ROWS, c16_rows_a_pass(NIN), C16_RING, c16_min_blocks(NIN)>;
  }
  static int tiles(int n, int h, int w) {
    return n * ((h + ROWS - 1) / ROWS) * ((w + C16_TW - 1) / C16_TW);
  }
};

template <int NIN, bool PM>
int launch_conv16(const Conv16Args<NIN>& a, cudaStream_t s) {
  using E = Conv16Entry<NIN, PM>;
  return tc::launch_persistent(E::kernel(), E::SMEM, E::tiles(a.n, a.h, a.w), s, a);
}

// D and E: inbloc.conv1, 2 -> 16 int8. D reads LST and NDVI as separate
// (N,H,W) planes; E (INTERLEAVED) reads one (N,H,W,2) tensor through `lst`,
// channel 0 = LST, 1 = NDVI, and ignores `ndvi`.
template <bool INTERLEAVED>
__global__ void __launch_bounds__(NT)
conv_i8_in1_kernel(const int8_t* __restrict__ lst, const int8_t* __restrict__ ndvi,
                   const int8_t* __restrict__ wt, const float* __restrict__ scale,
                   const float* __restrict__ bias, int8_t* __restrict__ out, int h, int w,
                   int relu) {
  __shared__ __align__(16) int32_t s_in[HALO];
  __shared__ __align__(16) int32_t s_w[9 * 16];
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  if (INTERLEAVED)
    load_halo_pair_interleaved(s_in, lst, n, y0, x0, h, w);
  else
    load_halo_pair(s_in, lst, ndvi, n, y0, x0, h, w);
  load_weights<2, 16>(s_w, wt);
  __syncthreads();
  int acc[16] = {};
  accumulate<1, 16>(acc, s_in, s_w);
  int8_t q[16];
#pragma unroll
  for (int co = 0; co < 16; ++co) q[co] = requant(dequant(acc[co], __ldg(scale + co), __ldg(bias + co)), relu);
  const int gy = y0 + threadIdx.x / TW, gx = x0 + threadIdx.x % TW;
  if (gy < h && gx < w) store16(out + (((size_t)n * h + gy) * w + gx) * 16, q);
}

// F: the outlay, 16 -> 1 int8 conv with a float32 output (N,H,W):
// y = acc * scale + bias, the caller folding the input scale and the Kelvin
// de-normalise into the two scalars. No ReLU, no requantise.
__global__ void __launch_bounds__(NT)
conv_i8_outlay_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ out, int h, int w) {
  __shared__ __align__(16) int32_t s_in[HALO * 4];
  __shared__ __align__(16) int32_t s_w[9 * 4];
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo<16>(s_in, x, n, y0, x0, h, w);
  load_weights<16, 1>(s_w, wt);
  __syncthreads();
  int acc[1] = {};
  accumulate<4, 1>(acc, s_in, s_w);
  const int gy = y0 + threadIdx.x / TW, gx = x0 + threadIdx.x % TW;
  if (gy < h && gx < w)
    out[((size_t)n * h + gy) * w + gx] = dequant(acc[0], __ldg(scale), __ldg(bias));
}

// Generic CIN -> COUT int8 conv with a float32 output (the mid chain and the
// outlay): y = acc*scale + bias [ReLU].
template <int CIN, int COUT>
__global__ void __launch_bounds__(NT)
conv_i8_generic_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       float* __restrict__ out, int h, int w, int relu) {
  constexpr int CW = CIN / 4;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_in = smem;
  int32_t* s_w = smem + HALO * CW;
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo<CIN>(s_in, x, n, y0, x0, h, w);
  load_weights<CIN, COUT>(s_w, wt);
  __syncthreads();
  int acc[COUT] = {};
  accumulate<CW, COUT>(acc, s_in, s_w);
  const int gy = y0 + threadIdx.x / TW, gx = x0 + threadIdx.x % TW;
  if (gy >= h || gx >= w) return;
  float* o = out + (((size_t)n * h + gy) * w + gx) * COUT;
  float y[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) {
    y[co] = dequant(acc[co], __ldg(scale + co), __ldg(bias + co));
    if (relu) y[co] = fmaxf(y[co], 0.f);
  }
  if constexpr (COUT % 4 == 0) {
#pragma unroll
    for (int co = 0; co < COUT; co += 4)
      *reinterpret_cast<float4*>(o + co) = make_float4(y[co], y[co + 1], y[co + 2], y[co + 3]);
  } else {
#pragma unroll
    for (int co = 0; co < COUT; ++co) o[co] = y[co];
  }
}

template <int CIN, int COUT>
int launch_generic(const void* x, const void* wt, const void* scale, const void* bias,
                   void* out, int n, int h, int w, int relu, cudaStream_t s) {
  constexpr int CW = CIN / 4;
  const size_t smem = (size_t)(HALO * CW + 9 * CW * COUT) * sizeof(int32_t);
  return launch(conv_i8_generic_kernel<CIN, COUT>, tile_grid(n, h, w), smem, s,
                static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<float*>(out), h, w, relu);
}

}  // namespace

extern "C" {

const char* sifsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// (cin, cout) pairs the generic entry point is built for: the ModelB2 mid
// chain (db1..db3, ub1, ub2), ub3 and the outlay, and inbloc.conv1 with its two
// input channels zero-padded to one 4-channel word.
#define SIFSR_GENERIC_SHAPES(X) \
  X(4, 16) X(16, 16) X(16, 32) X(32, 32) X(32, 64) X(64, 64) X(128, 64) X(64, 32) X(32, 16) \
  X(16, 1)

int sifsr_conv_i8_generic_supported(int cin, int cout) {
#define SIFSR_CASE(CI, CO) if (cin == CI && cout == CO) return 1;
  SIFSR_GENERIC_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return 0;
}

// x (N,H,W,16) int8 -> out (N,H,W,16) int8; pm (N,H/2,W/2,16) int8 when
// pm != NULL (H and W even).
int sifsr_conv_i8_exact(const void* x, const void* wt, const void* scale, const void* bias,
                        void* out, void* pm, float pm_scale, int n, int h, int w, int relu,
                        void* stream) {
  const Conv16Args<1> a{{static_cast<const int8_t*>(x)},
                        {static_cast<const int8_t*>(wt)},
                        {static_cast<const float*>(scale)},
                        static_cast<const float*>(bias),
                        static_cast<int8_t*>(out),
                        static_cast<int8_t*>(pm),
                        pm_scale, n, h, w, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pm ? launch_conv16<1, true>(a, s) : launch_conv16<1, false>(a, s);
}

// x, z (N,H,W,16) int8 -> out (N,H,W,16) int8.
int sifsr_conv_i8_exact_dual(const void* x, const void* z, const void* wx, const void* wz,
                             const void* sx, const void* sz, const void* bias, void* out,
                             int n, int h, int w, int relu, void* stream) {
  const Conv16Args<2> a{
      {static_cast<const int8_t*>(x), static_cast<const int8_t*>(z)},
      {static_cast<const int8_t*>(wx), static_cast<const int8_t*>(wz)},
      {static_cast<const float*>(sx), static_cast<const float*>(sz)},
      static_cast<const float*>(bias),
      static_cast<int8_t*>(out),
      nullptr, 0.f, n, h, w, relu};
  return launch_conv16<2, false>(a, static_cast<cudaStream_t>(stream));
}

// The launch of B or C for an (n,h,w,16) input, without launching: kind 0
// sifsr_conv_i8_exact, 1 the same with the phase mean, 2
// sifsr_conv_i8_exact_dual. Writes the persistent grid (blocks), the
// dynamic shared memory of a block in bytes and the number of tiles.
int sifsr_conv_i8_mma_shape(int kind, int n, int h, int w, int* blocks, int* smem, int* tiles) {
  if (kind == 0) return tc::entry_shape<Conv16Entry<1, false>>(n, h, w, blocks, smem, tiles);
  if (kind == 1) return tc::entry_shape<Conv16Entry<1, true>>(n, h, w, blocks, smem, tiles);
  if (kind == 2) return tc::entry_shape<Conv16Entry<2, false>>(n, h, w, blocks, smem, tiles);
  return (int)cudaErrorInvalidValue;
}

int sifsr_conv_i8_in1_split(const void* lst, const void* ndvi, const void* wt,
                            const void* scale, const void* bias, void* out, int n, int h,
                            int w, int relu, void* stream) {
  conv_i8_in1_kernel<false><<<tile_grid(n, h, w), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(lst), static_cast<const int8_t*>(ndvi),
      static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), h, w, relu);
  return (int)cudaGetLastError();
}

// x (N,H,W,2) int8, channel-interleaved -> out (N,H,W,16) int8.
int sifsr_conv_i8_in1(const void* x, const void* wt, const void* scale, const void* bias,
                      void* out, int n, int h, int w, int relu, void* stream) {
  conv_i8_in1_kernel<true><<<tile_grid(n, h, w), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), nullptr, static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<int8_t*>(out), h, w, relu);
  return (int)cudaGetLastError();
}

// x (N,H,W,16) int8, wt (3,3,16,1), scale/bias one float each -> out (N,H,W) f32.
int sifsr_conv_i8_outlay(const void* x, const void* wt, const void* scale, const void* bias,
                         void* out, int n, int h, int w, void* stream) {
  conv_i8_outlay_kernel<<<tile_grid(n, h, w), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), h, w);
  return (int)cudaGetLastError();
}

int sifsr_conv_i8_generic(const void* x, const void* wt, const void* scale, const void* bias,
                          void* out, int n, int h, int w, int cin, int cout, int relu,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFSR_CASE(CI, CO) \
  if (cin == CI && cout == CO) return launch_generic<CI, CO>(x, wt, scale, bias, out, n, h, w, relu, s);
  SIFSR_GENERIC_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
