// Phase-separated integer-factor upsample with an optional int8 epilogue.
//
// Replaces sifsr_tpu/pallas/resize_phases.py::upsample_phases (the
// pl.pallas_call at resize_phases.py:124). Output pixel (f*k + d, f*l + e) is
//     y = sum_j C[e, j][l] * r_d[k, l + delta_j],
//     r_d[k, w] = sum_i R[d, i][k] * x[k + delta_i, w],
// with per-row / per-column coefficient tables (align-corners and clamped
// cubic grids are not convolutions). Taps are summed in ascending delta
// order, rows first, every product and sum rounded on its own (__fmul_rn /
// __fadd_rn, built with -fmad=false), each sum starting from +0, so the
// result equals the Pallas kernel's and the plain version's bit for bit. A
// tap whose coefficient is 0 (every tap that leaves the image has one) adds
// 0 * v = +-0 with v read at the clamped position: a sum that starts at +0
// is never -0, and s + (+-0) == s bit for bit for every other s, so on
// finite inputs this equals skipping the tap, as the TPU form and the
// earlier one-row-a-block kernel did, without a branch a tap. The int8
// epilogue is clip(rint(y * (1/scale)), -127, 127), half-to-even, formed by
// float adds that give rintf's integer bit for bit (quant_bits).
//
// Bound on the H100: memory, at the two serving calls (batch 324, bytes =
// the float32 input read once and the int8 output written once):
//   cubic x4 of (324,64,64,1) -> (324,256,256,1):  26,542,080 B, 0.0079 ms
//   at 3.35 TB/s (its operations: 0.0031 ms at 67 TFLOP/s);
//   align-corners x2 of (324,128,128,16) -> (324,256,256,16): 679,477,248 B,
//   0.2028 ms (operations 0.0303 ms).
// The earlier kernel took one block of 256 threads an output row: 82,944
// blocks at both shapes, and at c = 1 a block of about a microsecond's work
// in which 64 threads ran the row pass and each store moved one byte.
//
// Design: a block takes one image and R consecutive output rows, R from
// the row's width alone, passed in by the host (kernels/resize_phases.py::
// _launch_shape, the one rule: the largest power of two <= 32 whose R * W*C
// floats of row pass fit in 32 KB, else 1 -- the earlier layout, which then
// takes the rows the earlier kernel took, W*C*4 <= 227 KB). Cubic x4 at 64²
// x 1: R = 32, 2,592 blocks; the x2 at 128² x 16: R = 4, 20,736 blocks.
//  * Row pass: the R rows of r_d into shared memory, each value computed
//    once, four columns a thread (float4 loads of x, 16-byte coalesced)
//    where W*C is a multiple of 4; every thread of the block works.
//  * Column pass: a thread takes a group of 4 consecutive output elements
//    (one 32-bit store of int8, one float4 of float32; a warp stores 128
//    contiguous bytes of int8) at one column position for several of the
//    block's rows, so that the group's column coefficients and source
//    offsets are read once into registers and serve every row. Where
//    C % 4 == 0 a group is one pixel's 4 channels (one float4 read of
//    shared memory a tap; lanes of a quarter warp read 64 contiguous bytes);
//    where C == 1 and f % 4 == 0 it is 4 phases of one source column (one
//    shared read a tap serves all 4; lanes read consecutive words). Other
//    shapes, or an output that is not 16-byte aligned, take the generic
//    form: the same groups, indices per element, one store an element.
//    (The starting design gave a thread 16 bytes of one row; 4 are enough
//    for whole 128-byte warp stores, keep shared reads free of bank
//    conflicts in both forms, and let the coefficients stay in registers
//    across the rows.)
// Index arithmetic is 32-bit within an image and the tap loops unroll at
// compile time, so the delta table stays in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;

struct Taps {
  int delta[kMaxTaps];
};

enum Form { kGeneric = 0, kPixel4 = 1, kPhase4 = 2 };

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// clip(rint(y * inv_scale), -127, 127) in the low byte of a float's bits,
// without the conversion unit (a quarter-rate pipe that two conversions an
// output, rintf and the float-to-int, kept busy): clipping first gives the
// same value (+-127 are integers; a NaN clips to -127 either way), and
// adding 1.5 * 2^23, whose ulp is 1, rounds half-to-even to an integer q
// with bits 0x4B400000 + q, whose low byte is q's.
__device__ __forceinline__ uint32_t quant_bits(float y, float inv_scale) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv_scale), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}

// the low bytes of four quant_bits, first in the lowest byte
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ void madd(float& s, float cw, float v) {
  s = __fadd_rn(s, __fmul_rn(cw, v));
}

// Threads of a block over (position, row) pairs: a thread keeps one
// position (and with it the position's coefficients) for rows rl0, rl0 +
// step, ... The positions (n of them) go to consecutive threads; where a
// row has fewer positions than the block threads, the threads split the
// rows: floor(threads / n) row slices.
struct Walk {
  int pos0, rl0, step;
  bool active;
  __device__ Walk(int n) {
    step = max(1, (int)blockDim.x / n);
    rl0 = threadIdx.x / n;
    pos0 = threadIdx.x - rl0 * n;
    active = rl0 < step;
  }
};

template <bool kInt8, int kForm, int NTAPS>
__global__ void __launch_bounds__(kThreads)
upsample_phases_kernel(const float* __restrict__ x, const float* __restrict__ rc,
                       const float* __restrict__ cc, Taps taps, int factor, int h, int w,
                       int c, int rows_per, int vec_rows, float inv_scale, void* out) {
  extern __shared__ float4 s_raw[];
  float* s_r = reinterpret_cast<float*>(s_raw);   // rows x (w * c) row-pass values
  const int n = blockIdx.y;
  const int fh = factor * h, wc = w * c, row_len = factor * wc;
  const int oy0 = blockIdx.x * rows_per;
  const int rows = min(rows_per, fh - oy0);
  const float* xn = x + (size_t)n * h * wc;

  // row pass
  const int nq = vec_rows ? wc >> 2 : wc;
  const Walk row_walk(nq);
  if (row_walk.active) {
    for (int q = row_walk.pos0; q < nq; q += blockDim.x) {
      for (int rl = row_walk.rl0; rl < rows; rl += row_walk.step) {
        const int oy = oy0 + rl, k = oy / factor, d = oy - k * factor;
        if (vec_rows) {
          float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < NTAPS; ++i) {
            const float cw = __ldg(rc + (d * NTAPS + i) * h + k);
            const int ky = clampi(k + taps.delta[i], h - 1);
            const float4 v = __ldg(reinterpret_cast<const float4*>(xn + ky * wc) + q);
            madd(r.x, cw, v.x);
            madd(r.y, cw, v.y);
            madd(r.z, cw, v.z);
            madd(r.w, cw, v.w);
          }
          reinterpret_cast<float4*>(s_r + rl * wc)[q] = r;
        } else {
          float r = 0.f;
#pragma unroll
          for (int i = 0; i < NTAPS; ++i) {
            const float cw = __ldg(rc + (d * NTAPS + i) * h + k);
            const int ky = clampi(k + taps.delta[i], h - 1);
            madd(r, cw, __ldg(xn + ky * wc + q));
          }
          s_r[rl * wc + q] = r;
        }
      }
    }
  }
  __syncthreads();

  // column pass over groups of 4 consecutive elements of a row
  const int ngroups = (row_len + 3) >> 2;
  const size_t out0 = ((size_t)n * fh + oy0) * row_len;
  const Walk col_walk(ngroups);
  if (!col_walk.active) return;
  for (int g = col_walk.pos0; g < ngroups; g += blockDim.x) {
    const int j0 = 4 * g;
    if constexpr (kForm == kPixel4) {
      // one pixel, channels ch0..ch0+3
      const int ox = j0 / c, ch0 = j0 - ox * c;
      const int l = ox / factor, e = ox - l * factor;
      float cw[NTAPS];
      int src[NTAPS];
#pragma unroll
      for (int t = 0; t < NTAPS; ++t) {
        cw[t] = __ldg(cc + (e * NTAPS + t) * w + l);
        src[t] = clampi(l + taps.delta[t], w - 1) * c + ch0;
      }
      for (int rl = col_walk.rl0; rl < rows; rl += col_walk.step) {
        const float* sr = s_r + rl * wc;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int t = 0; t < NTAPS; ++t) {
          const float4 v = *reinterpret_cast<const float4*>(sr + src[t]);
          madd(y.x, cw[t], v.x);
          madd(y.y, cw[t], v.y);
          madd(y.z, cw[t], v.z);
          madd(y.w, cw[t], v.w);
        }
        const size_t o = out0 + (size_t)rl * row_len + j0;
        if (kInt8) {
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) =
              pack4(quant_bits(y.x, inv_scale), quant_bits(y.y, inv_scale),
                    quant_bits(y.z, inv_scale), quant_bits(y.w, inv_scale));
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = y;
        }
      }
    } else if constexpr (kForm == kPhase4) {
      // c == 1: pixels j0..j0+3 share the source column l, phases e0..e0+3
      const int l = j0 / factor, e0 = j0 - l * factor;
      float cw[4][NTAPS];
      int src[NTAPS];
#pragma unroll
      for (int t = 0; t < NTAPS; ++t) {
#pragma unroll
        for (int u = 0; u < 4; ++u) cw[u][t] = __ldg(cc + ((e0 + u) * NTAPS + t) * w + l);
        src[t] = clampi(l + taps.delta[t], w - 1);
      }
      for (int rl = col_walk.rl0; rl < rows; rl += col_walk.step) {
        const float* sr = s_r + rl * wc;
        float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < NTAPS; ++t) {
          const float v = sr[src[t]];
#pragma unroll
          for (int u = 0; u < 4; ++u) madd(y[u], cw[u][t], v);
        }
        const size_t o = out0 + (size_t)rl * row_len + j0;
        if (kInt8) {
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) =
              pack4(quant_bits(y[0], inv_scale), quant_bits(y[1], inv_scale),
                    quant_bits(y[2], inv_scale), quant_bits(y[3], inv_scale));
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
              make_float4(y[0], y[1], y[2], y[3]);
        }
      }
    } else {
      // any c and factor, any alignment: indices per element, scalar stores
      const int nu = min(4, row_len - j0);
      float cw[4][NTAPS];
      int src[4][NTAPS];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + min(u, nu - 1);
        const int ox = j / c, ch = j - ox * c;
        const int l = ox / factor, e = ox - l * factor;
#pragma unroll
        for (int t = 0; t < NTAPS; ++t) {
          cw[u][t] = __ldg(cc + (e * NTAPS + t) * w + l);
          src[u][t] = clampi(l + taps.delta[t], w - 1) * c + ch;
        }
      }
      for (int rl = col_walk.rl0; rl < rows; rl += col_walk.step) {
        const float* sr = s_r + rl * wc;
        const size_t o = out0 + (size_t)rl * row_len + j0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= nu) break;
          float y = 0.f;
#pragma unroll
          for (int t = 0; t < NTAPS; ++t) madd(y, cw[u][t], sr[src[u][t]]);
          if (kInt8) {
            static_cast<uint8_t*>(out)[o + u] = (uint8_t)quant_bits(y, inv_scale);
          } else {
            static_cast<float*>(out)[o + u] = y;
          }
        }
      }
    }
  }
}

template <int kForm, int NTAPS>
int launch(const float* x, const float* rc, const float* cc, const Taps& taps, int factor,
           int n, int h, int w, int c, int rows, int vec_rows, float inv_scale, int out_int8,
           void* out, cudaStream_t s) {
  const dim3 grid((factor * h + rows - 1) / rows, n);
  const size_t smem = (size_t)rows * w * c * sizeof(float);
  auto kern = out_int8 ? upsample_phases_kernel<true, kForm, NTAPS>
                       : upsample_phases_kernel<false, kForm, NTAPS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, s>>>(x, rc, cc, taps, factor, h, w, c, rows, vec_rows,
                                    inv_scale, out);
  return (int)cudaGetLastError();
}

template <int NTAPS>
int launch_form(int form, const float* x, const float* rc, const float* cc, const Taps& taps,
                int factor, int n, int h, int w, int c, int rows, int vec_rows, float inv_scale,
                int out_int8, void* out, cudaStream_t s) {
  switch (form) {
    case kPixel4:
      return launch<kPixel4, NTAPS>(x, rc, cc, taps, factor, n, h, w, c, rows, vec_rows,
                                    inv_scale, out_int8, out, s);
    case kPhase4:
      return launch<kPhase4, NTAPS>(x, rc, cc, taps, factor, n, h, w, c, rows, vec_rows,
                                    inv_scale, out_int8, out, s);
    default:
      return launch<kGeneric, NTAPS>(x, rc, cc, taps, factor, n, h, w, c, rows, vec_rows,
                                     inv_scale, out_int8, out, s);
  }
}

}  // namespace

extern "C" {

const char* sifsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (N,H,W,C) f32; rc (factor, n_taps, H) and cc (factor, n_taps, W) f32
// coefficient tables over the ascending deltas; out (N, fH, fW, C) int8 when
// out_int8, else f32; a block takes `rows` output rows, whose rows * W*C
// floats of row pass must fit in 227 KB. Returns cudaGetLastError() after
// the launch.
int sifsr_upsample_phases(const void* x, const void* rc, const void* cc,
                          const int* deltas, int n_taps, int factor, int n,
                          int h, int w, int c, int rows, float inv_scale, int out_int8,
                          void* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || rows < 1 ||
      (size_t)rows * w * c * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < n_taps; ++i) taps.delta[i] = deltas[i];
  if (n == 0 || h == 0 || w == 0 || c == 0) return 0;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rcf = static_cast<const float*>(rc);
  const float* ccf = static_cast<const float*>(cc);
  // the vector forms store 4 elements at once (4 B of int8, 16 B of float32)
  // at multiples of 4 elements from out, so they need out 16-byte aligned
  const bool aligned = ((uintptr_t)out & 15) == 0;
  const int form = !aligned ? kGeneric
                   : c % 4 == 0 ? kPixel4
                   : (c == 1 && factor % 4 == 0) ? kPhase4 : kGeneric;
  const int vec_rows = (w * c) % 4 == 0 && ((uintptr_t)x & 15) == 0;
  switch (n_taps) {
#define SIFSR_TAPS(T)                                                                  \
  case T:                                                                              \
    return launch_form<T>(form, xf, rcf, ccf, taps, factor, n, h, w, c, rows, vec_rows,\
                          inv_scale, out_int8, out, s);
    SIFSR_TAPS(1) SIFSR_TAPS(2) SIFSR_TAPS(3) SIFSR_TAPS(4)
    SIFSR_TAPS(5) SIFSR_TAPS(6) SIFSR_TAPS(7) SIFSR_TAPS(8)
#undef SIFSR_TAPS
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
