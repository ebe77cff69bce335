// Phase-separated integer-factor upsample with an optional int8 epilogue.
//
// Replaces sifsr_tpu/pallas/resize_phases.py::upsample_phases (the
// pl.pallas_call at resize_phases.py:124). Output pixel (f*k + d, f*l + e) is
//     y = sum_j C[e, j][l] * r_d[k, l + delta_j],
//     r_d[k, w] = sum_i R[d, i][k] * x[k + delta_i, w],
// with per-row / per-column coefficient tables (align-corners and clamped
// cubic grids are not convolutions). Taps are summed in ascending delta
// order, rows first, every product and sum rounded on its own (__fmul_rn /
// __fadd_rn, built with -fmad=false), so the result equals the Pallas
// kernel's bit for bit; zero coefficients (which include every out-of-range
// tap) are skipped, which adds exact zeros in the TPU form. The int8
// epilogue is clip(rint(y * (1/scale)), -127, 127), half-to-even.
//
// Bound on the H100: memory. Per output element the kernel does at most
// 5x5 multiply-adds on float32 and writes one byte (int8) or four (float32);
// the serving shapes (cubic x4 of (N,64,64,1), align-corners x2 of
// (N,128,128,16)) move 4 input bytes per 4 (resp. 16) output elements.
// Design: one block per output row; the row pass for that row is computed
// once into shared memory (not once per output element and column tap),
// then consecutive threads write consecutive output elements (coalesced
// stores, the dominant traffic).
// Index arithmetic is 32-bit and the tap loops unroll at compile time, so
// the delta table stays in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;

struct Taps {
  int delta[kMaxTaps];
};

// One block per output row (f*k + d) of one image: the block first runs the
// row pass r_d[k, :] for all W*C columns into shared memory, then each
// thread produces output elements of the row from it (column pass).
template <bool kInt8, int NTAPS>
__global__ void __launch_bounds__(256)
upsample_phases_kernel(const float* __restrict__ x, const float* __restrict__ rc,
                       const float* __restrict__ cc, Taps taps, int factor, int h,
                       int w, int c, float inv_scale, void* out) {
  extern __shared__ float s_r[];  // w * c row-pass values
  const int oy = blockIdx.x, n = blockIdx.y;
  const int k = oy / factor, d = oy - k * factor;
  const int wc = w * c;
  const float* xn = x + (size_t)n * h * wc;

  float rw[NTAPS];
#pragma unroll
  for (int i = 0; i < NTAPS; ++i) rw[i] = __ldg(rc + (d * NTAPS + i) * h + k);
  for (int q = threadIdx.x; q < wc; q += blockDim.x) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < NTAPS; ++i) {
      if (rw[i] == 0.f) continue;
      r = __fadd_rn(r, __fmul_rn(rw[i], __ldg(xn + (k + taps.delta[i]) * wc + q)));
    }
    s_r[q] = r;
  }
  __syncthreads();

  const int row_len = factor * wc;
  const size_t base = ((size_t)n * factor * h + oy) * row_len;
  for (int j = threadIdx.x; j < row_len; j += blockDim.x) {
    const int ox = j / c, ch = j - ox * c;
    const int l = ox / factor, e = ox - l * factor;
    float y = 0.f;
#pragma unroll
    for (int t = 0; t < NTAPS; ++t) {
      const float cw = __ldg(cc + (e * NTAPS + t) * w + l);
      if (cw == 0.f) continue;
      y = __fadd_rn(y, __fmul_rn(cw, s_r[(l + taps.delta[t]) * c + ch]));
    }
    if (kInt8) {
      float qv = rintf(__fmul_rn(y, inv_scale));
      qv = fminf(fmaxf(qv, -127.f), 127.f);
      static_cast<int8_t*>(out)[base + j] = (int8_t)(int)qv;
    } else {
      static_cast<float*>(out)[base + j] = y;
    }
  }
}

template <int NTAPS>
int launch(const float* x, const float* rc, const float* cc, const Taps& taps, int factor,
           int n, int h, int w, int c, float inv_scale, int out_int8, void* out,
           cudaStream_t s) {
  const dim3 grid(factor * h, n);
  const size_t smem = (size_t)w * c * sizeof(float);
  auto kern = out_int8 ? upsample_phases_kernel<true, NTAPS> : upsample_phases_kernel<false, NTAPS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, 256, smem, s>>>(x, rc, cc, taps, factor, h, w, c, inv_scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sifsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (N,H,W,C) f32; rc (factor, n_taps, H) and cc (factor, n_taps, W) f32
// coefficient tables over the ascending deltas; out (N, fH, fW, C) int8 when
// out_int8, else f32. Returns cudaGetLastError() after the launch.
int sifsr_upsample_phases(const void* x, const void* rc, const void* cc,
                          const int* deltas, int n_taps, int factor, int n,
                          int h, int w, int c, float inv_scale, int out_int8,
                          void* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < n_taps; ++i) taps.delta[i] = deltas[i];
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rcf = static_cast<const float*>(rc);
  const float* ccf = static_cast<const float*>(cc);
  switch (n_taps) {
#define SIFSR_TAPS(T) \
  case T: return launch<T>(xf, rcf, ccf, taps, factor, n, h, w, c, inv_scale, out_int8, out, s);
    SIFSR_TAPS(1) SIFSR_TAPS(2) SIFSR_TAPS(3) SIFSR_TAPS(4)
    SIFSR_TAPS(5) SIFSR_TAPS(6) SIFSR_TAPS(7) SIFSR_TAPS(8)
#undef SIFSR_TAPS
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
