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
//   conv_prow_dual_planes (conv_px.py:563; entry sifsr_conv_prow_dual, kernel
//                          C's template of conv_tile.cuh at 32 and 64
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
// per image against a few tens of M int8 multiply-adds). Design, simple
// first: the 8x32-tile dp4a main loop of conv_tile.cuh. The x2 kernel
// computes the conv over an 8x32 region that holds a 6x30 source tile and
// its one-pixel ring, requantises it into shared memory and writes the
// 12x60 upsampled tile from there; the ring's values past the image border
// meet zero coefficients. The dp4a inner loop on the CUDA cores is the
// likely limit (times against the bound: PERF.md).

#include "conv_tile.cuh"

namespace {

// G: CIN -> COUT int8 conv, optional fused residual add.
template <int CIN, int COUT, bool RES>
__global__ void __launch_bounds__(NT)
conv_prow_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const int8_t* __restrict__ res, float res_sc, int8_t* __restrict__ out,
                 int h, int w, int relu) {
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
  const size_t o = (((size_t)n * h + gy) * w + gx) * COUT;
#pragma unroll
  for (int c0 = 0; c0 < COUT; c0 += 16) {
    int8_t v0[16], q[16];
    if (RES) unpack16(v0, __ldg(reinterpret_cast<const uint4*>(res + o + c0)));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float y = dequant(acc[c0 + j], __ldg(scale + c0 + j), __ldg(bias + c0 + j));
      if (relu) y = fmaxf(y, 0.f);
      if (RES) y = __fadd_rn(__fmul_rn(__int2float_rn((int)v0[j]), res_sc), y);
      q[j] = requant(y, false);
    }
    store16(out + o + c0, q);
  }
}

// H: CIN -> COUT int8 conv into out (N,H,W,COUT) and its exact 2x2 pool
// into pool (N,H/2,W/2,COUT).
template <int CIN, int COUT>
__global__ void __launch_bounds__(NT)
conv_prow_pool_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      int8_t* __restrict__ out, int8_t* __restrict__ pool, float pool_sc,
                      int h, int w, int relu) {
  constexpr int CW = CIN / 4, CH = COUT / 16;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_in = smem;
  int32_t* s_w = smem + HALO * CW;
  int8_t* s_q = reinterpret_cast<int8_t*>(s_w + 9 * CW * COUT);  // (TH*TW, COUT)
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  load_halo<CIN>(s_in, x, n, y0, x0, h, w);
  load_weights<CIN, COUT>(s_w, wt);
  __syncthreads();
  int acc[COUT] = {};
  accumulate<CW, COUT>(acc, s_in, s_w);
  const int gy = y0 + threadIdx.x / TW, gx = x0 + threadIdx.x % TW;
  const size_t o = (((size_t)n * h + gy) * w + gx) * COUT;
#pragma unroll
  for (int c0 = 0; c0 < COUT; c0 += 16) {
    int8_t q[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      q[j] = requant(dequant(acc[c0 + j], __ldg(scale + c0 + j), __ldg(bias + c0 + j)), relu);
    store16(s_q + threadIdx.x * COUT + c0, q);
    if (gy < h && gx < w) store16(out + o + c0, q);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (NT / 4) * CH; i += NT) {
    const int cell = i / CH, c0 = (i % CH) * 16;
    const int py = cell / (TW / 2), px = cell % (TW / 2);
    const int gpy = y0 / 2 + py, gpx = x0 / 2 + px;
    if (gpy >= h / 2 || gpx >= w / 2) continue;
    const int8_t* a = s_q + (2 * py * TW + 2 * px) * COUT + c0;
    int8_t a0[16], a1[16], b0[16], b1[16], p[16];
    unpack16(a0, *reinterpret_cast<const uint4*>(a));
    unpack16(a1, *reinterpret_cast<const uint4*>(a + COUT));
    unpack16(b0, *reinterpret_cast<const uint4*>(a + TW * COUT));
    unpack16(b1, *reinterpret_cast<const uint4*>(a + TW * COUT + COUT));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int sum4 = (int)a0[j] + (int)a1[j] + (int)b0[j] + (int)b1[j];
      p[j] = requant(__fmul_rn(__int2float_rn(sum4), pool_sc), false);
    }
    store16(pool + (((size_t)n * (h / 2) + gpy) * (w / 2) + gpx) * COUT + c0, p);
  }
}

// I and K: CIN -> COUT int8 conv requantised at the mid scale, then the
// align-corners x2 into out (N,2H,2W,COUT). rnum (2,3,H) and cnum (2,3,W)
// int32: the integer numerators of output row 2k+d (column 2l+e) for the
// source taps k-1, k, k+1 (l-1, l, l+1), zero where a tap leaves the image.
constexpr int UH = TH - 2, UW = TW - 2;  // source tile inside the conv region

// With VPU the tables are float32 (rc, cc of up2_coeffs) and the x2 runs the
// float chain; else int32 numerators and the integer chain.
template <int CIN, int COUT, bool VPU>
__global__ void __launch_bounds__(NT)
conv_prow_up2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const void* __restrict__ rtab, const void* __restrict__ ctab, float inv,
                     int8_t* __restrict__ out, int h, int w, int relu) {
  constexpr int CW = CIN / 4, CH = COUT / 16;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_in = smem;
  int32_t* s_w = smem + HALO * CW;
  int8_t* s_q = reinterpret_cast<int8_t*>(s_w + 9 * CW * COUT);  // (TH*TW, COUT)
  const int n = blockIdx.z, sy0 = blockIdx.y * UH, sx0 = blockIdx.x * UW;
  // conv region: source rows sy0-1 .. sy0+UH, columns sx0-1 .. sx0+UW
  load_halo<CIN>(s_in, x, n, sy0 - 1, sx0 - 1, h, w);
  load_weights<CIN, COUT>(s_w, wt);
  __syncthreads();
  int acc[COUT] = {};
  accumulate<CW, COUT>(acc, s_in, s_w);
#pragma unroll
  for (int c0 = 0; c0 < COUT; c0 += 16) {
    int8_t q[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      q[j] = requant(dequant(acc[c0 + j], __ldg(scale + c0 + j), __ldg(bias + c0 + j)), relu);
    store16(s_q + threadIdx.x * COUT + c0, q);
  }
  __syncthreads();
  const int oh = 2 * h, ow = 2 * w;
  for (int i = threadIdx.x; i < 2 * UH * 2 * UW * CH; i += NT) {
    const int c0 = (i % CH) * 16, pix = i / CH;
    const int oy = 2 * sy0 + pix / (2 * UW), ox = 2 * sx0 + pix % (2 * UW);
    if (oy >= oh || ox >= ow) continue;
    const int k = oy >> 1, d = oy & 1, l = ox >> 1, e = ox & 1;
    // tap (t, u) sits at conv-region row k-sy0+t, column l-sx0+u
    const int8_t* base = s_q + ((k - sy0) * TW + (l - sx0)) * COUT + c0;
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
          unpack16(v, *reinterpret_cast<const uint4*>(base + (t * TW + u) * COUT));
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
          unpack16(v, *reinterpret_cast<const uint4*>(base + (t * TW + u) * COUT));
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

template <int CIN, int COUT>
int launch_prow(const void* x, const void* wt, const void* scale, const void* bias,
                const void* res, float res_sc, void* out, int n, int h, int w, int relu,
                cudaStream_t s) {
  constexpr int CW = CIN / 4;
  const size_t smem = (size_t)(HALO * CW + 9 * CW * COUT) * sizeof(int32_t);
  auto kern = res ? conv_prow_kernel<CIN, COUT, true> : conv_prow_kernel<CIN, COUT, false>;
  return launch(kern, tile_grid(n, h, w), smem, s, static_cast<const int8_t*>(x),
                static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
                static_cast<const float*>(bias), static_cast<const int8_t*>(res), res_sc,
                static_cast<int8_t*>(out), h, w, relu);
}

template <int CIN, int COUT>
int launch_pool(const void* x, const void* wt, const void* scale, const void* bias, void* out,
                void* pool, float pool_sc, int n, int h, int w, int relu, cudaStream_t s) {
  constexpr int CW = CIN / 4;
  const size_t smem = (size_t)(HALO * CW + 9 * CW * COUT) * sizeof(int32_t) + NT * COUT;
  return launch(conv_prow_pool_kernel<CIN, COUT>, tile_grid(n, h, w), smem, s,
                static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<int8_t*>(out), static_cast<int8_t*>(pool), pool_sc, h, w, relu);
}

template <int CIN, int COUT, bool VPU>
int launch_up2(const void* x, const void* wt, const void* scale, const void* bias,
               const void* rtab, const void* ctab, float inv, void* out, int n, int h, int w,
               int relu, cudaStream_t s) {
  constexpr int CW = CIN / 4;
  const size_t smem = (size_t)(HALO * CW + 9 * CW * COUT) * sizeof(int32_t) + NT * COUT;
  const dim3 grid((w + UW - 1) / UW, (h + UH - 1) / UH, n);
  return launch(conv_prow_up2_kernel<CIN, COUT, VPU>, grid, smem, s,
                static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                static_cast<const float*>(scale), static_cast<const float*>(bias), rtab, ctab,
                inv, static_cast<int8_t*>(out), h, w, relu);
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
    return launch_prow<CI, CO>(x, wt, scale, bias, res, res_sc, out, n, h, w, relu, s);
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
    return launch_pool<CI, CO>(x, wt, scale, bias, out, pool, pool_sc, n, h, w, relu, s);
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
  if (c == 32) return launch_dual<32>(x, z, wx, wz, sx, sz, bias, out, n, h, w, relu, s);
  if (c == 64) return launch_dual<64>(x, z, wx, wz, sx, sz, bias, out, n, h, w, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
