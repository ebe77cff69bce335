// The int8 tensor-core main loops of the replicate-pad 3x3 convs: the one of
// inputs of 32 or more channels (kernels G and H at db2/db3, I, J, K and L in
// csrc/conv_px.cu), and the 16-channel tap-pair form (the kernels of
// csrc/conv16.cuh: B and C in csrc/conv_i8.cu, G and H at db1, and the
// 16 -> 1 outlay). D and E (2 input channels) build their A fragments
// themselves (csrc/conv_i8.cu); the generic conv keeps the dp4a loop of
// csrc/conv_tile.cuh.
//
// Implicit GEMM on mma.sync.m16n8k32 s8 x s8 -> s32: rows are output pixels,
// K runs over the 9 taps and the input channels in chunks of 32, N over the
// output channels. The A fragments come from the input halo in shared
// memory by ldmatrix: each lane names one pixel row, and the tap (dy, dx)
// only shifts that row address, so the im2col is never formed. Weights sit
// in shared memory as [tap][cout][cin] rows, the column-major B fragment of
// `.col`, also read by ldmatrix. int8 products summed in int32 are exact, so
// the accumulators equal those of the dp4a loop and every rounding after
// them (the epilogues) is unchanged.
//
// Rows of C int8 (a pixel of the halo, a cout row of the weights) are 16-byte
// chunks XOR-swizzled by row: the 8 rows one ldmatrix matrix reads are 8
// consecutive rows at the same logical chunk, and the swizzle puts them on 8
// distinct 16-byte bank groups (without it, 64-byte rows give a 4-way
// conflict). Halos are copied by 16-byte cp.async with the replicate clamp in
// the source address, into a ring of stages, so that a persistent block
// loads tile t+1 while it computes tile t.
//
// At 16 channels (conv16_mma) a halo pixel is exactly one 16-byte ldmatrix
// row, so K = 9 taps x 16 channels goes as tap pairs: chunk kc of the
// m16n8k32 product takes tap 2kc in k 0-15 and tap 2kc+1 in k 16-31, and
// tap 8 is one m16n8k16 product. The weights, 2.3 KB a conv, are few enough
// to stay in registers as B fragments for a persistent block's whole life.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {
namespace tc {

constexpr int WARPS = 8, THREADS = 32 * WARPS;

// Chunk index of logical 16-byte chunk c of row r in rows of CH chunks.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH >= 1 && 8 % CH == 0, "rows of 16, 32, 64 or 128 bytes");
  return r * CH + (c ^ ((r / (8 / CH)) % CH));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k16 product: A rows 0-7 / 8-15 at k 0-15 (a[0], a[1]), B k 0-15.
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Start the copy of the HH x HWD halo of a C-channel int8 NHWC image whose
// top-left pixel is image (y0, x0), replicate-clamped at the border, into s
// (swizzled rows of C bytes). The caller commits the group.
template <int C, int HH, int HWD>
__device__ __forceinline__ void load_halo_async(int8_t* s, const int8_t* __restrict__ x, int n,
                                                int y0, int x0, int h, int w) {
  constexpr int CH = C / 16;
  const uint32_t base = smem_u32(s);
  for (int i = threadIdx.x; i < HH * HWD * CH; i += THREADS) {
    const int c = i % CH, p = i / CH;
    const int gy = clampi(y0 + p / HWD, 0, h - 1);
    const int gx = clampi(x0 + p % HWD, 0, w - 1);
    cp_async16(base + swz<CH>(p, c) * 16, x + (((size_t)n * h + gy) * w + gx) * C + c * 16);
  }
}

// HWIO int8 weights (3,3,CIN,COUT) -> swizzled rows (tap * COUT + cout) of
// CIN bytes; consecutive threads read consecutive output channels. Each
// thread has the loads of WB words in flight before it stores them, so that
// a block's prologue waits for device memory a few times, not once a word.
template <int CIN, int COUT>
__device__ __forceinline__ void load_weights_rows(int8_t* s, const int8_t* __restrict__ wt) {
  constexpr int CH = CIN / 16, WPR = CIN / 4;  // chunks, 4-byte words per row
  constexpr int WORDS = 9 * COUT * WPR, WB = 6;
  for (int i0 = threadIdx.x; i0 < WORDS; i0 += WB * THREADS) {
    uint32_t word[WB];
#pragma unroll
    for (int b = 0; b < WB; ++b) {
      const int i = i0 + b * THREADS, co = i % COUT, t = i / COUT, wd = t % WPR, tap = t / WPR;
      word[b] = 0;
      if (i < WORDS) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word[b] |= (uint32_t)(uint8_t)__ldg(wt + (tap * CIN + wd * 4 + j) * COUT + co) << (8 * j);
      }
    }
#pragma unroll
    for (int b = 0; b < WB; ++b) {
      const int i = i0 + b * THREADS, co = i % COUT, t = i / COUT, wd = t % WPR, tap = t / WPR;
      if (i < WORDS)
        *reinterpret_cast<uint32_t*>(s + swz<CH>(tap * COUT + co, wd / 4) * 16 + (wd % 4) * 4) =
            word[b];
    }
  }
}

// ldmatrix row of this lane inside an m16 tile: lanes 0-7 and 16-23 name
// rows 0-7, lanes 8-15 and 24-31 rows 8-15 (matrices 0 and 2 hold k 0-15
// and 16-31 of rows 0-7, matrices 1 and 3 the same of rows 8-15).
__device__ __forceinline__ int a_row() {
  const int lane = threadIdx.x & 31;
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}

// acc[m][j] += conv over the 9 taps and CIN channels for MT m16 pixel tiles
// and NT n8 output-channel tiles from channel n0. s_in: the halo (rows of
// CIN bytes, HWD pixels a halo row); p0[m]: the halo pixel of this lane's
// ldmatrix row of tile m at tap (0, 0). s_w: load_weights_rows' layout.
// C fragment: acc[m][j][0..1] are pixel (lane >> 2) of tile m, channels
// n0 + 8j + 2(lane & 3) + {0, 1}; acc[m][j][2..3] the same of pixel
// (lane >> 2) + 8.
template <int CIN, int COUT, int HWD, int MT, int NT>
__device__ __forceinline__ void conv_mma(int (&acc)[MT][NT][4], const int8_t* s_in,
                                         const int8_t* s_w, const int (&p0)[MT], int n0) {
  static_assert(CIN % 32 == 0 && NT % 2 == 0, "k chunks of 32, n tiles in pairs");
  constexpr int CH = CIN / 16, KC = CIN / 32;
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = smem_u32(s_in), b_base = smem_u32(s_w);
  const int a_half = lane >> 4;                                   // k 0-15 or 16-31
  const int b_row = n0 + ((lane >> 4) << 3) + (lane & 7), b_half = (lane >> 3) & 1;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * HWD + tap % 3;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t b[NT][2];
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        uint32_t r[4];
        ldsm_x4(r, b_base + swz<CH>(tap * COUT + b_row + 16 * q, 2 * kc + b_half) * 16);
        b[2 * q][0] = r[0];
        b[2 * q][1] = r[1];
        b[2 * q + 1][0] = r[2];
        b[2 * q + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldsm_x4(a, a_base + swz<CH>(p0[m] + shift, 2 * kc + a_half) * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[m][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

// ---- The 16-channel form

// This lane's B fragments of a 16-channel conv with NT n8 output tiles: for
// tile j, output channel 8j + (lane >> 2), input channels 4(lane & 3) + 0..3
// of tap 2kc (pair[kc][j][0], k 0-15 of chunk kc) and tap 2kc+1 (pair[kc][j][1],
// k 16-31), and of tap 8 (last[j], the k16 product). 9 * NT words a lane.
template <int NT>
struct W16Frags {
  uint32_t pair[4][NT][2];
  uint32_t last[NT];
};

// From HWIO int8 weights (3,3,16,COUT) in device memory; the columns of the
// NT n8 tiles past COUT (the outlay's 1 of 8) hold zeros.
template <int NT, int COUT = 8 * NT>
__device__ __forceinline__ void load_w16(W16Frags<NT>& f, const int8_t* __restrict__ wt) {
  static_assert(COUT >= 1 && COUT <= 8 * NT, "COUT within the NT n8 tiles");
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  auto word = [&](int tap, int j) {
    uint32_t v = 0;
    if (COUT == 8 * NT || 8 * j + g < COUT) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v |= (uint32_t)(uint8_t)__ldg(wt + (tap * 16 + 4 * tq + b) * COUT + 8 * j + g) << (8 * b);
    }
    return v;
  };
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      f.pair[kc][j][0] = word(2 * kc, j);
      f.pair[kc][j][1] = word(2 * kc + 1, j);
    }
    f.last[j] = word(8, j);
  }
}

// Halo pixels between a pixel and its neighbour at tap (tap / 3, tap % 3).
template <int HWD>
__host__ __device__ constexpr int tap_shift(int tap) {
  return (tap / 3) * HWD + tap % 3;
}

// acc[m][j] += the 3x3 conv of a 16-channel halo (rows of 16 bytes, HWD
// pixels a halo row, unswizzled: 8 consecutive pixels are 128 contiguous
// bytes, conflict-free) for MT m16 pixel tiles; p0 and the C fragment as
// conv_mma's. ldmatrix.x4 takes the row addresses of its matrices 0-1 (k
// 0-15) from lanes 0-15 and of matrices 2-3 (k 16-31) from lanes 16-31, so
// lanes 0-15 name the pixel shifted by tap 2kc and lanes 16-31 the pixel
// shifted by tap 2kc+1; tap 8 goes through ldmatrix.x2 (lanes 0-15) and the
// k16 product. An m16 tile takes 4 ldmatrix.x4, 1 ldmatrix.x2 and 5 * NT
// products.
template <int HWD, int MT, int NT>
__device__ __forceinline__ void conv16_mma(int (&acc)[MT][NT][4], const int8_t* s_in,
                                           const W16Frags<NT>& wf, const int (&p0)[MT]) {
  const bool second = (threadIdx.x & 31) >= 16;
  const uint32_t base = smem_u32(s_in);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int shift = second ? tap_shift<HWD>(2 * kc + 1) : tap_shift<HWD>(2 * kc);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a[4];
      ldsm_x4(a, base + (p0[m] + shift) * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[m][j], a, wf.pair[kc][j][0], wf.pair[kc][j][1]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t a[2];
    ldsm_x2(a, base + (p0[m] + tap_shift<HWD>(8)) * 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_s8_k16(acc[m][j], a, wf.last[j]);
  }
}

// Exact conversions for the 16-channel epilogues on the float and integer
// pipes; Hopper's conversion unit gives 16 results a clock an SM, and an
// epilogue element needs two or three. int -> float: a 16-channel conv's
// |acc| <= 9 * 16 * 128 * 128 = 2,359,296 < 2^22, so the bits
// 0x4B400000 + acc are the float 1.5 * 2^23 + acc, and subtracting 1.5 * 2^23
// is exact: __int2float_rn(acc).
constexpr int I2F_BIAS = 0x4B400000;  // the bits of 1.5 * 2^23

// __int2float_rn(acc) from the bits I2F_BIAS + acc: an MMA whose int32 sums
// start at I2F_BIAS yields them, so that the add folds into the products.
__device__ __forceinline__ float i2f_biased(int bits) {
  return __fsub_rn(__int_as_float(bits), 12582912.f);
}

__device__ __forceinline__ float i2f_small(int v) { return i2f_biased(I2F_BIAS + v); }

// requant (conv_tile.cuh) as the int8 in the low byte: [ReLU], clip to
// [-127, 127] (before the rounding: the bounds are integers and rint is
// monotone, so the value is the same), then rint, half to even, as the
// round-to-nearest-even of y + 1.5 * 2^23, whose unit in the last place is 1;
// the low byte of the sum's bits is the rounded value's two's complement.
__device__ __forceinline__ uint32_t requant_bits(float y, bool relu) {
  y = fminf(fmaxf(y, relu ? 0.f : -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, 12582912.f));
}

// Two int8 values as one 16-bit word (byte 0 first).
__device__ __forceinline__ uint16_t pack2(int8_t a, int8_t b) {
  return (uint16_t)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8));
}

// Grid of a persistent kernel: as many blocks as fit on the card at once,
// at most one a tile. Sets the kernel's dynamic shared-memory limit first.
template <typename... KArgs>
int persistent_grid(void (*kern)(KArgs...), size_t smem, int n_tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1 || n_tiles < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  return 0;
}

template <typename... KArgs, typename... Args>
int launch_persistent(void (*kern)(KArgs...), size_t smem, int n_tiles, cudaStream_t s,
                      Args... args) {
  int grid = 0;
  const int e = persistent_grid(kern, smem, n_tiles, &grid);
  if (e != 0) return e;
  kern<<<grid, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// The shape query of an entry E (E::SMEM, E::kernel(), E::tiles(n, h, w)):
// the persistent grid, shared memory a block and tiles of its launch.
template <typename E>
int entry_shape(int n, int h, int w, int* blocks, int* smem, int* tiles) {
  *smem = (int)E::SMEM;
  *tiles = E::tiles(n, h, w);
  return persistent_grid(E::kernel(), E::SMEM, *tiles, blocks);
}

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

}  // namespace tc
}  // namespace
