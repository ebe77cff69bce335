// Replicate-padded 3x3 int8 convolutions on NHWC tensors, int32 accumulate,
// float32 dequantise epilogue.
//
// Replaces, from sifsr_tpu/pallas/conv_i8.py:
//   conv_i8_exact      (pl.pallas_call at conv_i8.py:358 and :375; entry
//                       sifsr_conv_i8_exact, with the fused 2x2 phase mean)
//   conv_i8_exact_dual (conv_i8.py:408; entry sifsr_conv_i8_exact_dual)
//   conv_i8_in1_split  (conv_i8.py:755; entry sifsr_conv_i8_in1_split)
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
// the card's int8 rate). Design, simple first: one block of 256 threads per
// 8x32 output tile, each thread one pixel and all its output channels; the
// (8+2)x(32+2) input halo is loaded once into shared memory with the
// replicate clamp applied to the load addresses (no padded copy in device
// memory), four channels per 32-bit word; weights sit in shared memory in
// the same 4-channel words and the inner product is dp4a, fed by 128-bit
// shared loads (4 weight words of 4 output channels, 4 input words). Each
// tensor is read once from device memory and written once, outputs as
// 16-byte stores. The dp4a inner loop, not memory, is the likely limit of
// this form (times against the bound: PERF.md); int8 tensor-core MMA is the
// planned next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 32, NT = TH * TW;  // output tile, threads
constexpr int HH = TH + 2, HW = TW + 2, HALO = HH * HW;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Halo tile of a CIN-channel int8 NHWC image (CIN % 4 == 0) as words of 4
// channels, replicate-clamped at the image border.
template <int CIN>
__device__ __forceinline__ void load_halo(int32_t* s, const int8_t* __restrict__ x,
                                          int n, int y0, int x0, int h, int w) {
  constexpr int CW = CIN / 4;
  const int32_t* xw = reinterpret_cast<const int32_t*>(x);
  for (int i = threadIdx.x; i < HALO * CW; i += NT) {
    const int cw = i % CW, p = i / CW;
    const int gy = clampi(y0 - 1 + p / HW, 0, h - 1);
    const int gx = clampi(x0 - 1 + p % HW, 0, w - 1);
    s[i] = __ldg(xw + (((size_t)n * h + gy) * w + gx) * CW + cw);
  }
}

// Halo tile of two single-channel int8 images in one word: byte 0 from a,
// byte 1 from b (channels 2, 3 zero).
__device__ __forceinline__ void load_halo_pair(int32_t* s, const int8_t* __restrict__ a,
                                               const int8_t* __restrict__ b, int n,
                                               int y0, int x0, int h, int w) {
  for (int i = threadIdx.x; i < HALO; i += NT) {
    const int gy = clampi(y0 - 1 + i / HW, 0, h - 1);
    const int gx = clampi(x0 - 1 + i % HW, 0, w - 1);
    const size_t o = ((size_t)n * h + gy) * w + gx;
    s[i] = (int32_t)((uint32_t)(uint8_t)__ldg(a + o) |
                     ((uint32_t)(uint8_t)__ldg(b + o) << 8));
  }
}

// HWIO int8 weights (3,3,CIN,COUT) -> words [tap][ceil(CIN/4)][COUT] holding
// four input channels each (zero-padded past CIN).
template <int CIN, int COUT>
__device__ __forceinline__ void load_weights(int32_t* s, const int8_t* __restrict__ wt) {
  constexpr int CW = (CIN + 3) / 4;
  for (int i = threadIdx.x; i < 9 * CW * COUT; i += NT) {
    const int co = i % COUT, t = i / COUT, cw = t % CW, tap = t / CW;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = cw * 4 + j;
      if (ci < CIN)
        word |= (uint32_t)(uint8_t)__ldg(wt + (tap * CIN + ci) * COUT + co) << (8 * j);
    }
    s[i] = (int32_t)word;
  }
}

// acc[co] += x[co-th word] . w for 4 output channels at a time: one 128-bit
// shared load brings the weight words of 4 output channels.
template <int COUT>
__device__ __forceinline__ void dot_word(int (&acc)[COUT], int xv, const int32_t* wrow) {
  if constexpr (COUT % 4 == 0) {
    const int4* w4 = reinterpret_cast<const int4*>(wrow);
#pragma unroll
    for (int q = 0; q < COUT / 4; ++q) {
      const int4 wv = w4[q];
      acc[4 * q + 0] = __dp4a(xv, wv.x, acc[4 * q + 0]);
      acc[4 * q + 1] = __dp4a(xv, wv.y, acc[4 * q + 1]);
      acc[4 * q + 2] = __dp4a(xv, wv.z, acc[4 * q + 2]);
      acc[4 * q + 3] = __dp4a(xv, wv.w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[co] = __dp4a(xv, wrow[co], acc[co]);
  }
}

// acc[co] += sum over the 3x3 taps and CW channel words of this thread's
// pixel; input words come four at a time (one 128-bit load) when CW allows.
template <int CW, int COUT>
__device__ __forceinline__ void accumulate(int (&acc)[COUT], const int32_t* s_in,
                                           const int32_t* s_w) {
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int32_t* px = s_in + ((ty + dy) * HW + tx + dx) * CW;
      const int32_t* wt = s_w + (dy * 3 + dx) * CW * COUT;
      if constexpr (CW % 4 == 0) {
#pragma unroll 2
        for (int cw = 0; cw < CW; cw += 4) {
          const int4 xv = *reinterpret_cast<const int4*>(px + cw);
          dot_word(acc, xv.x, wt + (cw + 0) * COUT);
          dot_word(acc, xv.y, wt + (cw + 1) * COUT);
          dot_word(acc, xv.z, wt + (cw + 2) * COUT);
          dot_word(acc, xv.w, wt + (cw + 3) * COUT);
        }
      } else {
#pragma unroll
        for (int cw = 0; cw < CW; ++cw) dot_word(acc, px[cw], wt + cw * COUT);
      }
    }
  }
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

__device__ __forceinline__ int8_t requant(float y, bool relu) {
  if (relu) y = fmaxf(y, 0.f);
  y = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return (int8_t)(int)y;
}

__device__ __forceinline__ uint32_t pack4(const int8_t* q) {
  return (uint32_t)(uint8_t)q[0] | ((uint32_t)(uint8_t)q[1] << 8) |
         ((uint32_t)(uint8_t)q[2] << 16) | ((uint32_t)(uint8_t)q[3] << 24);
}

__device__ __forceinline__ void store16(int8_t* dst, const int8_t (&q)[16]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack4(q), pack4(q + 4), pack4(q + 8), pack4(q + 12));
}

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

// C: conv(concat(x, z)) = conv_x(x)*scale_x + conv_z(z)*scale_z + bias,
// 16 + 16 -> 16 int8; the concat is never formed.
__global__ void __launch_bounds__(NT)
conv_i8_dual_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ z,
                    const int8_t* __restrict__ wx, const int8_t* __restrict__ wz,
                    const float* __restrict__ sx, const float* __restrict__ sz,
                    const float* __restrict__ bias, int8_t* __restrict__ out, int h,
                    int w, int relu) {
  __shared__ __align__(16) int32_t s_x[HALO * 4], s_z[HALO * 4];
  __shared__ __align__(16) int32_t s_wx[9 * 4 * 16], s_wz[9 * 4 * 16];
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo<16>(s_x, x, n, y0, x0, h, w);
  load_halo<16>(s_z, z, n, y0, x0, h, w);
  load_weights<16, 16>(s_wx, wx);
  load_weights<16, 16>(s_wz, wz);
  __syncthreads();
  int ax[16] = {}, az[16] = {};
  accumulate<4, 16>(ax, s_x, s_wx);
  accumulate<4, 16>(az, s_z, s_wz);
  int8_t q[16];
#pragma unroll
  for (int co = 0; co < 16; ++co) {
    const float yx = __fmul_rn(__int2float_rn(ax[co]), __ldg(sx + co));
    const float yz = __fmul_rn(__int2float_rn(az[co]), __ldg(sz + co));
    q[co] = requant(__fadd_rn(__fadd_rn(yx, yz), __ldg(bias + co)), relu);
  }
  const int gy = y0 + threadIdx.x / TW, gx = x0 + threadIdx.x % TW;
  if (gy < h && gx < w) store16(out + (((size_t)n * h + gy) * w + gx) * 16, q);
}

// D: inbloc.conv1, 2 -> 16 int8 with LST and NDVI as separate (N,H,W) inputs.
__global__ void __launch_bounds__(NT)
conv_i8_in1_kernel(const int8_t* __restrict__ lst, const int8_t* __restrict__ ndvi,
                   const int8_t* __restrict__ wt, const float* __restrict__ scale,
                   const float* __restrict__ bias, int8_t* __restrict__ out, int h, int w,
                   int relu) {
  __shared__ __align__(16) int32_t s_in[HALO];
  __shared__ __align__(16) int32_t s_w[9 * 16];
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
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
  auto kern = conv_i8_generic_kernel<CIN, COUT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  kern<<<grid, NT, smem, s>>>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                              static_cast<const float*>(scale), static_cast<const float*>(bias),
                              static_cast<float*>(out), h, w, relu);
  return (int)cudaGetLastError();
}

inline dim3 tile_grid(int n, int h, int w) {
  return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, n);
}

}  // namespace

extern "C" {

const char* sifsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// (cin, cout) pairs the generic entry point is built for: the ModelB2 mid
// chain (db1..db3, ub1, ub2) and the outlay.
#define SIFSR_GENERIC_SHAPES(X) \
  X(16, 16) X(16, 32) X(32, 32) X(32, 64) X(64, 64) X(128, 64) X(64, 32) X(32, 16) X(16, 1)

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
  conv_i8_dual_kernel<<<tile_grid(n, h, w), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(z),
      static_cast<const int8_t*>(wx), static_cast<const int8_t*>(wz),
      static_cast<const float*>(sx), static_cast<const float*>(sz),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), h, w, relu);
  return (int)cudaGetLastError();
}

int sifsr_conv_i8_in1_split(const void* lst, const void* ndvi, const void* wt,
                            const void* scale, const void* bias, void* out, int n, int h,
                            int w, int relu, void* stream) {
  conv_i8_in1_kernel<<<tile_grid(n, h, w), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(lst), static_cast<const int8_t*>(ndvi),
      static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), h, w, relu);
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
