// The 8x32-tile dp4a main loop of the generic replicate-pad 3x3 int8 conv
// of csrc/conv_i8.cu (every shape but the outlay's 16 -> 1): halo and weight
// loads into shared memory, the int32 inner product; and the float32
// epilogue helpers and 16-byte int8 stores that every conv kernel uses.
// Kernels B-L and the outlay run on the int8 tensor cores instead
// (conv_mma.cuh, conv16.cuh, conv_i8.cu).
//
// One block of 256 threads per 8x32 output tile, each thread one pixel and
// all its output channels; the (8+2)x(32+2) input halo is loaded once into
// shared memory with the replicate clamp applied to the load addresses (no
// padded copy in device memory), four channels per 32-bit word; weights sit
// in shared memory in the same 4-channel words and the inner product is
// dp4a, fed by 128-bit shared loads. Rounding rules of the Pallas kernels:
// int32 sums, y = acc * scale + bias as two roundings (__fmul_rn, __fadd_rn;
// built with -fmad=false), rint (half to even), clip to [-127, 127].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 32, NT = TH * TW;  // output tile, threads
constexpr int HH = TH + 2, HW = TW + 2, HALO = HH * HW;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Halo tile of a CIN-channel int8 NHWC image (CIN % 4 == 0) as words of 4
// channels, replicate-clamped at the image border. (y0, x0) is the image
// position of the tile's first output pixel; the halo starts one pixel
// above and left of it.
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

// 16 int8 values from a 16-byte aligned address.
__device__ __forceinline__ void unpack16(int8_t (&q)[16], uint4 v) {
  const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = (int8_t)(wv[i / 4] >> (8 * (i % 4)));
}

// Launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit first where it passes the default 48 KB; returns a CUDA error code.
template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, NT, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

inline dim3 tile_grid(int n, int h, int w) {
  return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, n);
}

}  // namespace
