// The sensor-model kernels of the training losses: the PSF-downscale
// "sandwich" Y = A·X·Aᵀ + C and the fused norm-L4 block pool.
//
// sandwich_kernel replaces sifsr_tpu/pallas/fused_ops.py::_sandwich (the
// pl.pallas_call at fused_ops.py:51), which serves both
// fused_psf_downscale's forward (A = M, the (64, 256) collapsed
// pad/PSF/bicubic/crop matrix, C the renormalisation constant) and its
// backward (A = Mᵀ, no constant). It is one entry point with runtime
// dimensions (n, in, out), as the JAX package reuses _sandwich.
//
// The TPU kernel holds one whole 256x256 float32 image (256 KB) in VMEM per
// grid step; an SM has at most 227 KB of shared memory, so the block
// structure is not carried over. Here a block computes kRows output rows of
// one image:
//   step 1  T = A[r0:r0+kRows, :]·X       (kRows, in)   into shared memory,
//           one thread per column of X (coalesced reads of X rows), the A
//           tile transposed in shared memory so that one 128-bit broadcast
//           load feeds four multiply-adds;
//   step 2  Y[r0:r0+kRows, :] = T·Aᵀ + C  (kRows, out), one thread per
//           (four rows, one output column); Aᵀ is passed as its own
//           row-major array so that these reads are coalesced too.
// n·ceil(out/kRows) blocks: 128 for the forward at batch 32, 512 for the
// backward. Every output element is summed by one thread in ascending
// index order, so the result is deterministic (no atomics).
//
// Arithmetic is float32 throughout with explicit fused multiply-adds
// (__fmaf_rn: one rounding per term, not two), whatever -fmad flag the
// source is built with; the JAX kernel asks for Precision.HIGHEST, so no
// TF32 and no tensor-core down-conversion. A is dense here as on the TPU,
// although M is banded.
//
// Bound on the H100: at batch 32 the forward moves 8.9 MB (3 us at
// 3.35 TB/s) and does 0.34 GFLOP (5 us at 67 TFLOP/s): bound by
// operations, and at this size launch latency is of the same order.
//
// norm_l4_kernel replaces sifsr_tpu/pallas/fused_ops.py::fused_norm_l4 (the
// pl.pallas_call at fused_ops.py:146): y = (mean over each f x f block of
// (x*std + mean)^4)^(1/4), optionally (y - mean)/std. The TPU kernel takes
// the block mean as two matmuls with an averaging matrix because Mosaic
// cannot reshape the block; here one thread sums its block directly, rows
// then columns. Bound by bytes (each input read once: 8.4 MB at
// (32, 256, 256), 2.7 us); with f = 4 a thread reads one aligned 16-byte
// word per block row, so a warp reads 512 consecutive bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;      // output rows per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sandwich_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ at, const float* __restrict__ cst,
                float* __restrict__ y, int in, int out, int tiles) {
  extern __shared__ float4 smem4[];
  float* s_a = reinterpret_cast<float*>(smem4);  // [in][kRows]: the A tile, transposed
  float* s_t = s_a + (size_t)in * kRows;         // [in][kRows]: T, transposed
  const int n = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - n * tiles) * kRows;
  const float* xn = x + (size_t)n * in * in;

  // consecutive threads read consecutive k of one row of A; rows past
  // `out` (a ragged last tile) are zero
  for (int i = threadIdx.x; i < kRows * in; i += kThreads) {
    const int tr = i / in, k = i - tr * in;
    s_a[k * kRows + tr] = (r0 + tr < out) ? __ldg(a + (size_t)(r0 + tr) * in + k) : 0.f;
  }
  __syncthreads();

  // step 1: T[:, j] = sum_k A[r0 + :, k] * X[k, j]
  for (int j = threadIdx.x; j < in; j += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
#pragma unroll 8
    for (int k = 0; k < in; ++k) {
      const float xv = __ldg(xn + (size_t)k * in + j);
      const float4* ak = reinterpret_cast<const float4*>(s_a + k * kRows);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 m = ak[q];
        acc[4 * q + 0] = __fmaf_rn(m.x, xv, acc[4 * q + 0]);
        acc[4 * q + 1] = __fmaf_rn(m.y, xv, acc[4 * q + 1]);
        acc[4 * q + 2] = __fmaf_rn(m.z, xv, acc[4 * q + 2]);
        acc[4 * q + 3] = __fmaf_rn(m.w, xv, acc[4 * q + 3]);
      }
    }
    float4* tj = reinterpret_cast<float4*>(s_t + j * kRows);
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q)
      tj[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();

  // step 2: Y[r0 + 4g + (0..3), o] = sum_j T[4g + (0..3), j] * At[j, o] + C
  const int items = (kRows / 4) * out;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int g = i / out, o = i - g * out;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < in; ++j) {
      const float m = __ldg(at + (size_t)j * out + o);
      const float4 t = *reinterpret_cast<const float4*>(s_t + j * kRows + 4 * g);
      acc.x = __fmaf_rn(t.x, m, acc.x);
      acc.y = __fmaf_rn(t.y, m, acc.y);
      acc.z = __fmaf_rn(t.z, m, acc.z);
      acc.w = __fmaf_rn(t.w, m, acc.w);
    }
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int r = r0 + 4 * g + d;
      if (r < out) {
        const size_t at_ro = (size_t)r * out + o;
        y[(size_t)n * out * out + at_ro] =
            cst ? __fadd_rn(v[d], __ldg(cst + at_ro)) : v[d];
      }
    }
  }
}

// One thread per output element. kVec4: f == 4, w % 4 == 0 and x aligned to
// 16 bytes, so that each block row is one float4.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
norm_l4_kernel(const float* __restrict__ x, float* __restrict__ y, int h, int w, int f,
               float mean, float sd, int renorm, size_t total) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int ow = w / f, oh = h / f;
  const int ox = (int)(i % ow);
  const size_t r = i / ow;
  const int oy = (int)(r % oh);
  const size_t n = r / oh;
  const float* p = x + (n * h + (size_t)oy * f) * w + (size_t)ox * f;

  float s = 0.f;
  auto add = [&](float v) {
    const float u = __fadd_rn(__fmul_rn(v, sd), mean);
    const float u2 = __fmul_rn(u, u);
    s = __fadd_rn(s, __fmul_rn(u2, u2));
  };
  if (kVec4) {
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + (size_t)dy * w));
      add(v.x); add(v.y); add(v.z); add(v.w);
    }
  } else {
    for (int dy = 0; dy < f; ++dy)
      for (int dx = 0; dx < f; ++dx) add(__ldg(p + (size_t)dy * w + dx));
  }
  float v = sqrtf(sqrtf(__fdiv_rn(s, (float)(f * f))));
  if (renorm) v = __fdiv_rn(__fsub_rn(v, mean), sd);
  y[i] = v;
}

}  // namespace

extern "C" {

const char* sifsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y (n, out, out) = a·x[i]·aᵀ + cst for each image: x (n, in, in), a (out, in)
// and at = aᵀ (in, out), both row-major, cst (out, out) or null; all float32.
// Returns cudaGetLastError() after the launch.
int sifsr_sandwich(const void* x, const void* a, const void* at, const void* cst, void* y,
                   int n, int in, int out, void* stream) {
  if (n < 0 || in < 1 || out < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int tiles = (out + kRows - 1) / kRows;
  if ((long long)n * tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)in * kRows * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sandwich_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sandwich_kernel<<<n * tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(at), static_cast<const float*>(cst),
      static_cast<float*>(y), in, out, tiles);
  return (int)cudaGetLastError();
}

// y (n, h/f, w/f) from x (n, h, w), float32; h and w are multiples of f.
int sifsr_norm_l4(const void* x, void* y, int n, int h, int w, int f, float mean, float sd,
                  int renorm, void* stream) {
  if (n < 0 || f < 1 || h < f || w < f || h % f || w % f) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)n * (h / f) * (w / f);
  if (total == 0) return 0;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647ULL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const bool vec4 = f == 4 && w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec4)
    norm_l4_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(xf, yf, h, w, f, mean, sd,
                                                              renorm, total);
  else
    norm_l4_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(xf, yf, h, w, f, mean, sd,
                                                               renorm, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
