// The sensor-model kernels of the training losses: the PSF-downscale
// "sandwich" Y = A·X·Aᵀ + C and the fused norm-L4 block pool.
//
// sandwich_kernel replaces sifsr_tpu/pallas/fused_ops.py::_sandwich (the
// pl.pallas_call at fused_ops.py:51), which serves both
// fused_psf_downscale's forward (A = M, the (64, 256) collapsed
// pad/PSF/bicubic/crop matrix, C the renormalisation constant) and its
// backward (A = Mᵀ, no constant). It is one entry point with runtime
// dimensions (n, in, out, width), as the JAX package reuses _sandwich.
//
// A is banded: row r of M has at most 2·factor + 4 nonzeros, one contiguous
// run (12 of 256 at factor 4), and a row of Mᵀ at most 4. The TPU kernel
// multiplies it densely on the MXU; here A comes as a band, row r's
// `width` coefficients from column lo[r] (built on the host, zeros where a
// row is shorter, lo[r] + width <= in), and every sum runs over the band
// alone: 21 times fewer operations than the dense product at factor 4.
//
// Bound on the H100, at batch 32: the forward reads X (8.4 MB) and writes
// Y (0.5 MB), the backward reads g (0.5 MB) and writes dx (8.4 MB): 8.9 MB,
// 2.7 us at 3.35 TB/s, against 15.6 MFLOP (0.23 us at 67 TFLOP/s). So bytes
// bind, and at this size so does the latency of one block's chain (launch,
// stage, two steps, store): every block of the grid is resident at once,
// and the kernel takes about as long as one block does. A block takes one
// image and `rows` consecutive output rows (8 forward, 256 blocks; 32
// backward, 256 blocks):
//   stage  the rows of X its bands cover (40 rows of 1 KB for 8 forward rows
//          at factor 4; the host passes each tile's range by value) and the
//          tile's band into shared memory with cp.async, every copy issued
//          before any is waited for; meanwhile each thread loads its step-2
//          columns' band into registers;
//   step 1 T = A[r0:r0+rows, :]·X (rows, in) into shared memory, a thread a
//          row and four consecutive columns (128-bit shared loads);
//   step 2 Y[r0:r0+rows, :] = T·Aᵀ + C, a thread one group of columns over
//          every few rows: forward, where neighbouring outputs read columns
//          `factor` apart, one column (a warp's stores 128 contiguous
//          bytes; T keeps column j at j + j/32, so those reads hit distinct
//          banks); backward, where they read the same columns of T, four
//          consecutive columns stored as one 16-byte word.
// Rows of X that two tiles share (8 of 40 forward) are read twice, the
// second time from L2.
//
// Larger images: where the staged rows of X would not fit beside T, the
// block stages them `chunk` columns at a time (a multiple of 4) and runs
// step 1 on each chunk in turn, T staying whole; where T itself would not
// fit, the host halves `rows` (kernels/fused_ops.py::_tiling, the one rule).
// 1024² at factor 8 stages 76 rows of X in two chunks of 512 columns,
// 2048² at factor 2 22 rows in two of 1,024; every sum keeps its order, so
// at the shapes the one-chunk kernel took the outputs are its bits. A
// launch takes at most kMaxTiles row tiles (their ranges ride in the
// parameters); the entry launches a larger image's tiles in turns of
// kMaxTiles. The band is at most kMaxBand wide (factor 16: 36; factor 30:
// 64), the coefficients a step-2 thread holds in registers.
//
// Arithmetic is float32 with one __fmaf_rn a term (one rounding, whatever
// -fmad flag the source is built with), every sum from 0 in ascending
// column order, and C added by its own __fadd_rn: the roundings of the JAX
// kernel's two Precision.HIGHEST products (no TF32, no tensor cores). The
// terms the band leaves out are exact zeros, and fma(0, x, s) == s for a
// finite x, so on finite inputs the outputs equal a dense product's in the
// same order bit for bit. A non-finite input spoils only the outputs whose
// band covers it (the dense product spoils the whole image).
//
// norm_l4_kernel replaces sifsr_tpu/pallas/fused_ops.py::fused_norm_l4 (the
// pl.pallas_call at fused_ops.py:146): y = (mean over each f x f block of
// (x*std + mean)^4)^(1/4), optionally (y - mean)/std. The TPU kernel takes
// the block mean as two matmuls with an averaging matrix because Mosaic
// cannot reshape the block; here one thread sums its block directly, rows
// then columns. Bound by bytes (each input read once: 8.4 MB at
// (32, 256, 256), 2.7 us) or, at the (32, 64, 64) of the scale-invariance
// recipe (0.56 MB), by the card's floor for one launch; with f = 4 a thread
// reads one aligned 16-byte word per block row, so a warp reads 512
// consecutive bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBand = 64;   // the widest band the sandwich takes (factor 16: 36)
constexpr int kMaxTiles = 128; // row tiles of one image a launch takes

// Each tile's first and last-plus-one row of X, passed by value: the kernel
// reads it from the launch's constant bank, with no memory round trip.
struct TileRows {
  int2 k[kMaxTiles];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// T's row keeps column j at j + j/32: outputs `factor` columns apart (any
// power of two up to 32) then read distinct banks.
__host__ __device__ inline int tcol(int j) { return j + (j >> 5); }

// Shared memory of a block, in floats: the tile's rows of the band (rows x
// width coefficients, rows starts), padded to 16 bytes, then T (rows x
// tpitch), then the staged rows of X (span x x_pitch(min(chunk, in))); a
// pitch is a column count rounded up to a multiple of 4.
__host__ __device__ inline int band_words(int rows, int width) {
  return (rows * (width + 1) + 3) & ~3;
}
__host__ __device__ inline int x_pitch(int in) { return (in + 3) & ~3; }
__host__ __device__ inline int t_pitch(int in) { return (tcol(x_pitch(in)) + 3) & ~3; }

// kVec: outputs a thread computes in step 2 (1, or 4 consecutive columns
// stored as one float4: out % 4 == 0); kMaxW: the widest band it takes,
// whose coefficients a thread holds in registers. The launch takes `tiles`
// row tiles from tile0 on; tile_in.k[t]: the first and the last-plus-one
// row of X the bands of tile tile0 + t cover. chunk: the columns of X staged
// at once (a multiple of 4, or at least `in`).
template <int kVec, int kMaxW>
__global__ void __launch_bounds__(kThreads, kVec == 4 ? 4 : kMaxW > 32 ? 1 : 2)
sandwich_kernel(const float* __restrict__ x, const int* __restrict__ lo,
                const float* __restrict__ coef, const __grid_constant__ TileRows tile_in,
                const float* __restrict__ cst, float* __restrict__ y, int in, int out,
                int width, int rows, int tiles, int tile0, int chunk) {
  extern __shared__ float4 smem4[];
  const int tp = t_pitch(in), pitch = x_pitch(min(chunk, in));
  const int n = blockIdx.x / tiles, tile = blockIdx.x - n * tiles;
  const int r0 = (tile0 + tile) * rows;
  const int nr = min(rows, out - r0);
  float* s_c = reinterpret_cast<float*>(smem4);            // [nr][width]
  int* s_lo = reinterpret_cast<int*>(s_c + nr * width);    // [nr]
  float* s_t = s_c + band_words(rows, width);              // [rows][tp]
  float* s_x = s_t + rows * tp;                            // [k1 - k0][pitch]

  // step 2's operands: a thread keeps one group of kVec columns (their
  // starts and coefficients in registers) over every row_par-th row
  const int groups = out / kVec;
  const int per_row = min(groups, kThreads);
  const int row_par = kThreads / per_row;
  const int t_first = threadIdx.x / per_row;
  int g = threadIdx.x % per_row;
  int l[kVec];
  float a[kVec][kMaxW];
  auto load_group = [&]() {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      l[e] = __ldg(lo + g * kVec + e);
#pragma unroll
      for (int w = 0; w < kMaxW; ++w)
        a[e][w] = w < width ? __ldg(coef + (g * kVec + e) * width + w) : 0.f;
    }
  };

  // stage the rows of X the tile's bands cover, a chunk of columns at a
  // time, and the tile's band
  const int2 kr = tile_in.k[tile];
  const int k0 = kr.x, nk = kr.y - kr.x;
  const float* xk = x + ((size_t)n * in + k0) * in;
  const bool vec = (in & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int j0 = 0; j0 < in; j0 += chunk) {
    const int nj = min(chunk, in - j0);
    if (vec) {
      const int q = nj >> 2;
      for (int i = threadIdx.x; i < nk * q; i += kThreads) {
        const int k = i / q, j = i - k * q;
        cp_async16(s_x + k * pitch + 4 * j, xk + (size_t)k * in + j0 + 4 * j);
      }
    } else {
      // the pitch's padding columns stay unwritten: the T columns they give
      // are never read, since lo + width <= in
      for (int i = threadIdx.x; i < nk * nj; i += kThreads) {
        const int k = i / nj, j = i - k * nj;
        cp_async4(s_x + k * pitch + j, xk + (size_t)k * in + j0 + j);
      }
    }
    if (j0 == 0) {
      for (int i = threadIdx.x; i < nr * width; i += kThreads)
        cp_async4(s_c + i, coef + (size_t)r0 * width + i);
      for (int i = threadIdx.x; i < nr; i += kThreads) cp_async4(s_lo + i, lo + r0 + i);
      load_group();   // while the copies land
    }
    cp_async_wait_all();
    __syncthreads();

    // step 1: T[t][j..j+3] = sum_w A[r0+t][lo+w] * X[lo+w][j..j+3]
    const int q4 = x_pitch(nj) >> 2, xq = pitch >> 2;
    for (int i = threadIdx.x; i < nr * q4; i += kThreads) {
      const int t = i / q4, j4 = i - t * q4;
      const float* at = s_c + t * width;
      const float4* xr = reinterpret_cast<const float4*>(s_x + (s_lo[t] - k0) * pitch) + j4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int w = 0; w < width; ++w) {
        const float m = at[w];
        const float4 v = xr[w * xq];
        acc.x = __fmaf_rn(m, v.x, acc.x);
        acc.y = __fmaf_rn(m, v.y, acc.y);
        acc.z = __fmaf_rn(m, v.z, acc.z);
        acc.w = __fmaf_rn(m, v.w, acc.w);
      }
      float* tr = s_t + t * tp + tcol(j0 + 4 * j4);   // four columns within one 32-column run
      tr[0] = acc.x;
      tr[1] = acc.y;
      tr[2] = acc.z;
      tr[3] = acc.w;
    }
    __syncthreads();
  }

  // step 2: Y[r0+t][c] = sum_w T[t][lo[c]+w] * A[c][lo[c]+w] (+ C[r0+t][c])
  float* yn = y + (size_t)n * out * out;
  while (t_first < row_par && g < groups) {
    for (int t = t_first; t < nr; t += row_par) {
      const float* tr = s_t + t * tp;
      float v[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kMaxW; ++w) {
          if (w >= width) break;
          acc = __fmaf_rn(tr[tcol(l[e] + w)], a[e][w], acc);
        }
        v[e] = acc;
      }
      const size_t at = (size_t)(r0 + t) * out + g * kVec;
      if (cst) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = __fadd_rn(v[e], __ldg(cst + at + e));
      }
      if (kVec == 4)
        *reinterpret_cast<float4*>(yn + at) = make_float4(v[0], v[1], v[2], v[3]);
      else
        yn[at] = v[0];
    }
    g += per_row;
    if (g < groups) load_group();
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

// y (n, out, out) = A·x[i]·Aᵀ + cst for each image of x (n, in, in), with A
// (out, in) given as a band: row r's `width` coefficients coef (out, width)
// from column lo[r] (int32, lo[r] + width <= in); cst (out, out) or null;
// all float32 and contiguous on the device. A block takes `rows` output
// rows, tile t the rows of x from tile_in[2t] to tile_in[2t+1] (int32, in
// host memory), at most `span` rows, staged `chunk` columns at a time.
// Returns cudaGetLastError() after the last launch.
int sifsr_sandwich(const void* x, const void* lo, const void* coef, const int* tile_in,
                   const void* cst, void* y, int n, int in, int out, int width, int rows,
                   int span, int chunk, void* stream) {
  if (n < 0 || in < 1 || out < 1 || width < 1 || width > kMaxBand || width > in || rows < 1 ||
      span < width || span > in || chunk < 1 || (chunk < in && chunk % 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int tiles = (out + rows - 1) / rows;
  for (int t = 0; t < tiles; ++t)
    if (tile_in[2 * t] < 0 || tile_in[2 * t + 1] > in ||
        tile_in[2 * t + 1] - tile_in[2 * t] > span)
      return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)band_words(rows, width) + (size_t)rows * t_pitch(in) +
                       (size_t)span * x_pitch(chunk < in ? chunk : in)) * sizeof(float);
  if (smem > 227 * 1024 || (long long)n * (tiles < kMaxTiles ? tiles : kMaxTiles) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quads = out % 4 == 0 && out > in && width <= 4;
  auto launch = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    for (int t0 = 0; t0 < tiles; t0 += kMaxTiles) {
      const int nt = tiles - t0 < kMaxTiles ? tiles - t0 : kMaxTiles;
      TileRows tr;
      for (int t = 0; t < nt; ++t)
        tr.k[t] = make_int2(tile_in[2 * (t0 + t)], tile_in[2 * (t0 + t) + 1]);
      kernel<<<n * nt, kThreads, smem, s>>>(
          static_cast<const float*>(x), static_cast<const int*>(lo),
          static_cast<const float*>(coef), tr, static_cast<const float*>(cst),
          static_cast<float*>(y), in, out, width, rows, nt, t0, chunk);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaSuccess;
  };
  if (quads) return launch(sandwich_kernel<4, 4>);
  return width <= 32 ? launch(sandwich_kernel<1, 32>) : launch(sandwich_kernel<1, kMaxBand>);
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
