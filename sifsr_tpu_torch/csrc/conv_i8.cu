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
// the card's int8 rate). Design, simple first: the 8x32-tile dp4a main loop
// of conv_tile.cuh (halo and weights in shared memory, one thread per output
// pixel and all its channels). Each tensor is read once from device memory
// and written once, outputs as 16-byte stores. The dp4a inner loop, not
// memory, is the likely limit of this form (times against the bound:
// PERF.md); int8 tensor-core MMA is the planned next step. Kernel C is the
// shared dual template of conv_tile.cuh at 16 channels. The outlay kernel
// reads 16 bytes and writes 4 per pixel for 144 multiply-adds: one thread per
// output pixel, float32 stores coalesced along the image row (the TPU form's
// 8-useful-lane output and the transpose after it do not exist here).

#include "conv_tile.cuh"

namespace {

// B: 16 -> 16 int8, optional fused phase mean (2x2 pool of the requantised
// output, requantised by pm_scale) into pm (N, H/2, W/2, 16).
template <bool PM>
__global__ void __launch_bounds__(NT)
conv_i8_exact_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     int8_t* __restrict__ out, int8_t* __restrict__ pm, float pm_scale,
                     int h, int w, int relu) {
  __shared__ __align__(16) int32_t s_in[HALO * 4];
  __shared__ __align__(16) int32_t s_w[9 * 4 * 16];
  __shared__ __align__(16) int8_t s_q[PM ? NT * 16 : 16];
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo<16>(s_in, x, n, y0, x0, h, w);
  load_weights<16, 16>(s_w, wt);
  __syncthreads();
  int acc[16] = {};
  accumulate<4, 16>(acc, s_in, s_w);
  int8_t q[16];
#pragma unroll
  for (int co = 0; co < 16; ++co) q[co] = requant(dequant(acc[co], __ldg(scale + co), __ldg(bias + co)), relu);
  const int gy = y0 + threadIdx.x / TW, gx = x0 + threadIdx.x % TW;
  if (gy < h && gx < w) store16(out + (((size_t)n * h + gy) * w + gx) * 16, q);
  if (PM) {
    store16(s_q + threadIdx.x * 16, q);
    __syncthreads();
    if (threadIdx.x < NT / 4) {
      const int py = threadIdx.x / (TW / 2), px = threadIdx.x % (TW / 2);
      const int gpy = y0 / 2 + py, gpx = x0 / 2 + px;
      if (gpy < h / 2 && gpx < w / 2) {
        const int8_t* a = s_q + (2 * py * TW + 2 * px) * 16;
        const int8_t* c = a + TW * 16;
        int8_t p[16];
#pragma unroll
        for (int co = 0; co < 16; ++co) {
          const int sum4 = (int)a[co] + (int)a[16 + co] + (int)c[co] + (int)c[16 + co];
          p[co] = requant(__fmul_rn(__int2float_rn(sum4), pm_scale), false);
        }
        store16(pm + (((size_t)n * (h / 2) + gpy) * (w / 2) + gpx) * 16, p);
      }
    }
  }
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
// pm != NULL.
int sifsr_conv_i8_exact(const void* x, const void* wt, const void* scale, const void* bias,
                        void* out, void* pm, float pm_scale, int n, int h, int w, int relu,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wt);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (pm)
    conv_i8_exact_kernel<true><<<tile_grid(n, h, w), NT, 0, s>>>(
        xi, wi, sc, b, static_cast<int8_t*>(out), static_cast<int8_t*>(pm), pm_scale, h, w, relu);
  else
    conv_i8_exact_kernel<false><<<tile_grid(n, h, w), NT, 0, s>>>(
        xi, wi, sc, b, static_cast<int8_t*>(out), nullptr, 0.f, h, w, relu);
  return (int)cudaGetLastError();
}

int sifsr_conv_i8_exact_dual(const void* x, const void* z, const void* wx, const void* wz,
                             const void* sx, const void* sz, const void* bias, void* out,
                             int n, int h, int w, int relu, void* stream) {
  return launch_dual<16>(x, z, wx, wz, sx, sz, bias, out, n, h, w, relu,
                         static_cast<cudaStream_t>(stream));
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
