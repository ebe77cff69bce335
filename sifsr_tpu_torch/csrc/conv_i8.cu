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
// B and C run on the int8 tensor cores, in the persistent 16-channel kernel
// of conv16.cuh (the tap-pair loop of conv_mma.cuh), which kernels G and H
// share at db1 (csrc/conv_px.cu): the dp4a loop they had before took 576
// dp4a a pixel for B, ~0.8 ms of the INT32 pipe a call at batch 324 against
// ~0.21 ms of bytes. B streams 32x32 output tiles, C 16x32 ones, through a
// three-stage cp.async halo ring; B's phase mean pools the 2x2 cells of each
// warp's own row pairs.
//
// D, E, F and the generic conv keep the 8x32-tile dp4a main loop of
// conv_tile.cuh (halo and weights in shared memory, one thread per output
// pixel and all its channels); each tensor is read once from device memory
// and written once, outputs as 16-byte stores. The outlay kernel reads 16
// bytes and writes 4 per pixel for 144 multiply-adds: one thread per output
// pixel, float32 stores coalesced along the image row (the TPU form's
// 8-useful-lane output and the transpose after it do not exist here).

#include "conv16.cuh"

namespace {

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

// What an entry launches: kernel B (NIN 1, with or without the phase mean)
// or C (NIN 2) of conv16.cuh at 16 output channels.
template <int NIN, bool PM>
using BCEntry = tc::Conv16Entry<NIN, 16, PM, false, c16_rows(NIN), c16_rows_a_pass(NIN), C16_RING,
                                c16_min_blocks(NIN)>;

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
  const tc::Conv16Args<1> a{{static_cast<const int8_t*>(x)},
                            {static_cast<const int8_t*>(wt)},
                            {static_cast<const float*>(scale)},
                            static_cast<const float*>(bias),
                            static_cast<int8_t*>(out),
                            static_cast<int8_t*>(pm),
                            pm_scale, nullptr, 0.f, n, h, w, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pm ? BCEntry<1, true>::launch(a, s) : BCEntry<1, false>::launch(a, s);
}

// x, z (N,H,W,16) int8 -> out (N,H,W,16) int8.
int sifsr_conv_i8_exact_dual(const void* x, const void* z, const void* wx, const void* wz,
                             const void* sx, const void* sz, const void* bias, void* out,
                             int n, int h, int w, int relu, void* stream) {
  const tc::Conv16Args<2> a{
      {static_cast<const int8_t*>(x), static_cast<const int8_t*>(z)},
      {static_cast<const int8_t*>(wx), static_cast<const int8_t*>(wz)},
      {static_cast<const float*>(sx), static_cast<const float*>(sz)},
      static_cast<const float*>(bias),
      static_cast<int8_t*>(out),
      nullptr, 0.f, nullptr, 0.f, n, h, w, relu};
  return BCEntry<2, false>::launch(a, static_cast<cudaStream_t>(stream));
}

// The launch of B or C for an (n,h,w,16) input, without launching: kind 0
// sifsr_conv_i8_exact, 1 the same with the phase mean, 2
// sifsr_conv_i8_exact_dual. Writes the persistent grid (blocks), the
// dynamic shared memory of a block in bytes and the number of tiles.
int sifsr_conv_i8_mma_shape(int kind, int n, int h, int w, int* blocks, int* smem, int* tiles) {
  if (kind == 0) return tc::entry_shape<BCEntry<1, false>>(n, h, w, blocks, smem, tiles);
  if (kind == 1) return tc::entry_shape<BCEntry<1, true>>(n, h, w, blocks, smem, tiles);
  if (kind == 2) return tc::entry_shape<BCEntry<2, false>>(n, h, w, blocks, smem, tiles);
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
