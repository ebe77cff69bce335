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
// B, C, D, E and the outlay run on the int8 tensor cores (mma.sync m16n8k32
// s8) in persistent blocks:
// - B and C in the 16-channel kernel of conv16.cuh (the tap-pair loop of
//   conv_mma.cuh), which kernels G and H share at db1 (csrc/conv_px.cu). B
//   streams 32x32 output tiles, C 16x32 ones, through a three-stage cp.async
//   halo ring; B's phase mean pools the 2x2 cells of each warp's own row
//   pairs.
// - D and E (2 -> 16) as one k32 chunk a pixel: K = 9 taps x 2 channels = 18,
//   zero-padded to 32, so 16 pixels take two products (one an n8 tile)
//   where the dp4a loop they had took 16 x 144 dp4a. Below.
// - The outlay (F, and the generic entry at 16 -> 1, the main path's outlay
//   call) in the sibling of the 16-channel kernel at one n8 tile
//   (conv16.cuh): one float32 value a pixel, a warp's 32-pixel row as one
//   128-byte store.
// The other shapes of the generic conv keep the 8x32-tile dp4a loop of
// conv_tile.cuh (halo and weights in shared memory, one thread per output
// pixel and all its channels).
//
// Every tensor-core epilogue converts on the float and integer pipes
// (i2f_small, requant_bits of conv_mma.cuh: the values of __int2float_rn and
// rintf while |acc| < 2^22; D's accumulators stay below 18 * 128^2, the
// outlay's below 144 * 128^2), since Hopper's conversion unit gives 16
// results a clock an SM.

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

// The launch of D and E (IN1_ROWS x 32 output tiles, IN1_ROWS / 8 rows a
// warp, the register cap of four blocks an SM) and of the outlay (OL_ROWS x 32
// tiles, OL_RING halo stages). On the H100 (kernels/tc_variants.py) 16-row
// tiles ran D 6-9 % slower (in1_rows), five blocks an SM (in1_blocks) and a
// fourth stage for the outlay (ol_ring) within noise.
constexpr int IN1_ROWS = 32;
constexpr int IN1_MIN_BLOCKS = 4;
constexpr int OL_ROWS = 32;
constexpr int OL_RING = 3;
constexpr int OL_MIN_BLOCKS = 4;

using OutlayEntry = tc::OutlayEntry<OL_ROWS, OL_RING, OL_MIN_BLOCKS>;

// D and E: inbloc.conv1, 2 -> 16 int8, requant(relu(acc*scale + bias)). D
// reads LST and NDVI as separate (N,H,W) planes; E (INTERLEAVED) reads one
// (N,H,W,2) tensor through `lst`, channel 0 = LST, 1 = NDVI, and ignores
// `ndvi`.
//
// The k order of the one k32 chunk is k = 2 * tap + channel, that of the
// HWIO weights flattened, so the B fragments come straight from (3,3,2,16):
// lane (g, t) holds output channel 8j + g, k 4t..4t+3 (taps 2t and 2t+1) and
// k 16+4t..19+4t (tap 8 for t = 0, zeros past k 17). The halo sits in shared
// memory as 2-byte pixels (byte 0 LST, byte 1 NDVI), so a lane's A word of
// pixel p is the pixel at tap 2t shifted from p in its low half and the one
// at tap 2t+1 in its high half: two 16-bit loads. Rows of IN1_PITCH pixels
// put the three tap rows one load reaches on disjoint banks.
//
// The planes are 1 byte a pixel and a tile's halo starts at x0 - 1, so no
// 16-byte copy is aligned for every tile and width: each thread loads its
// halo pixels of the next tile into registers (replicate clamp in the
// address, the two planes' bytes joined on the way) while the block computes
// this tile, and writes them into the other of two halo buffers after it;
// one barrier a tile. The accumulators start at I2F_BIAS, which folds
// i2f_small's add into the products. The input is 11 % of D's bytes; its
// 16-channel output the rest, staged as conv16.cuh stages it and written as
// coalesced 16-byte stores, one pixel each.
constexpr int IN1_PITCH = 40;

template <int ROWS>
struct In1Layout {
  static constexpr int HH = ROWS + 2, HWD = 34;                     // halo rows, pixels a row
  static constexpr int FILL = HH * HWD;                             // halo pixels a tile
  static constexpr int PF = (FILL + tc::THREADS - 1) / tc::THREADS;  // of them a thread's
  static constexpr size_t HALO = (size_t)HH * IN1_PITCH * 2;        // one halo buffer, bytes
  static constexpr size_t OFF_HALO = (size_t)ROWS * 32 * 16;        // after the output tile
  static constexpr size_t BYTES = OFF_HALO + 2 * HALO;
};

template <bool INTERLEAVED, int ROWS, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
conv_in1_mma_kernel(const int8_t* __restrict__ lst, const int8_t* __restrict__ ndvi,
                    const int8_t* __restrict__ wt, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ out, int n, int h,
                    int w, int relu) {
  using L = In1Layout<ROWS>;
  constexpr int RPW = ROWS / tc::WARPS;  // tile rows a warp
  static_assert(ROWS % tc::WARPS == 0, "whole rows a warp");
  extern __shared__ __align__(128) int8_t in1_smem[];
  const int tiles_x = (w + 31) / 32, per_img = tiles_x * ((h + ROWS - 1) / ROWS);
  const int n_tiles = n * per_img;
  uint32_t pf[L::PF];  // this thread's halo pixels of the next tile
  auto fetch = [&](int t) {
    const int img = t / per_img, r = t % per_img;
    const int y0 = (r / tiles_x) * ROWS - 1, x0 = (r % tiles_x) * 32 - 1;
#pragma unroll
    for (int k = 0; k < L::PF; ++k) {
      const int i = threadIdx.x + k * tc::THREADS;
      if (i < L::FILL) {
        const int gy = clampi(y0 + i / L::HWD, 0, h - 1), gx = clampi(x0 + i % L::HWD, 0, w - 1);
        const size_t o = ((size_t)img * h + gy) * w + gx;
        if constexpr (INTERLEAVED)
          pf[k] = __ldg(reinterpret_cast<const uint16_t*>(lst) + o);
        else
          pf[k] = (uint32_t)(uint8_t)__ldg(lst + o) | (uint32_t)(uint8_t)__ldg(ndvi + o) << 8;
      }
    }
  };
  fetch(blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  uint32_t b[2][2];         // n tile j: k 4tq..4tq+3, k 16+4tq..19+4tq of channel 8j + g
  float sc[2][2], bi[2][2];  // of this lane's channels 8j + 2tq + e
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * hf + 4 * tq + e;
        if (k < 18) v |= (uint32_t)(uint8_t)__ldg(wt + k * 16 + 8 * j + g) << (8 * e);
      }
      b[j][hf] = v;
      sc[j][hf] = __ldg(scale + 8 * j + 2 * tq + hf);
      bi[j][hf] = __ldg(bias + 8 * j + 2 * tq + hf);
    }
  // halo offsets of taps 2tq and 2tq+1 (a[0], a[1]) and of tap 8 (a[2], a[3],
  // lanes tq = 0; the others' are masked to zero)
  const int off0 = (2 * tq / 3) * IN1_PITCH + 2 * tq % 3;
  const int off1 = ((2 * tq + 1) / 3) * IN1_PITCH + (2 * tq + 1) % 3;
  constexpr int OFF8 = 2 * IN1_PITCH + 2;
  const uint32_t mask8 = tq == 0 ? 0xffffu : 0u;
  int8_t* s_o = in1_smem + warp * RPW * 32 * 16;  // this warp's rows of the output tile
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    uint16_t* hb = reinterpret_cast<uint16_t*>(in1_smem + L::OFF_HALO + (it & 1) * L::HALO);
#pragma unroll
    for (int k = 0; k < L::PF; ++k) {
      const int i = threadIdx.x + k * tc::THREADS;
      if (i < L::FILL) hb[(i / L::HWD) * IN1_PITCH + i % L::HWD] = (uint16_t)pf[k];
    }
    __syncthreads();  // the halo is in; every warp is past the last tile's s_o reads
    if (t + (int)gridDim.x < n_tiles) fetch(t + gridDim.x);
    const int img = t / per_img, rt = t % per_img;
    const int y0 = (rt / tiles_x) * ROWS + warp * RPW, x0 = (rt % tiles_x) * 32;
#pragma unroll 1
    for (int r = 0; r < RPW; ++r) {
      int acc[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint16_t* p = hb + (warp * RPW + r) * IN1_PITCH + 16 * m + g;
        const uint32_t a[4] = {(uint32_t)p[off0] | (uint32_t)p[off1] << 16,
                               (uint32_t)p[off0 + 8] | (uint32_t)p[off1 + 8] << 16,
                               p[OFF8] & mask8, p[OFF8 + 8] & mask8};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][j][c] = tc::I2F_BIAS;
          tc::mma_s8(acc[m][j], a, b[j][0], b[j][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t q[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              q[e] = tc::requant_bits(
                  __fadd_rn(__fmul_rn(tc::i2f_biased(acc[m][j][2 * hf + e]), sc[j][e]), bi[j][e]),
                  relu != 0);
            const int pix = r * 32 + 16 * m + g + 8 * hf;
            *reinterpret_cast<uint16_t*>(s_o + pix * 16 + 8 * j + 2 * tq) =
                (uint16_t)__byte_perm(q[0], q[1], 0x0040);
          }
    }
    __syncwarp();
    for (int k = lane; k < RPW * 32; k += 32) {
      const int gy = y0 + k / 32, gx = x0 + k % 32;
      if (gy < h && gx < w)
        *reinterpret_cast<uint4*>(out + (((size_t)img * h + gy) * w + gx) * 16) =
            *reinterpret_cast<const uint4*>(s_o + k * 16);
    }
  }
}

template <bool INTERLEAVED>
struct In1Entry {
  static constexpr size_t SMEM = In1Layout<IN1_ROWS>::BYTES;
  static auto kernel() { return conv_in1_mma_kernel<INTERLEAVED, IN1_ROWS, IN1_MIN_BLOCKS>; }
  static int tiles(int n, int h, int w) {
    return n * ((h + IN1_ROWS - 1) / IN1_ROWS) * ((w + 31) / 32);
  }
  static int launch(const void* lst, const void* ndvi, const void* wt, const void* scale,
                    const void* bias, void* out, int n, int h, int w, int relu, cudaStream_t s) {
    return tc::launch_persistent(kernel(), SMEM, tiles(n, h, w), s,
                                 static_cast<const int8_t*>(lst), static_cast<const int8_t*>(ndvi),
                                 static_cast<const int8_t*>(wt), static_cast<const float*>(scale),
                                 static_cast<const float*>(bias), static_cast<int8_t*>(out), n, h,
                                 w, relu);
  }
};

// Generic CIN -> COUT int8 conv with a float32 output (the mid chain of
// mid='xla' and the convs of --int8): y = acc*scale + bias [ReLU].
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

// (cin, cout) pairs the generic entry point runs on the dp4a kernel: the
// ModelB2 mid chain (db1..db3, ub1, ub2) and ub3, and inbloc.conv1 with its
// two input channels zero-padded to one 4-channel word. The outlay's 16 -> 1
// runs on the outlay kernel.
#define SIFSR_GENERIC_SHAPES(X) \
  X(4, 16) X(16, 16) X(16, 32) X(32, 32) X(32, 64) X(64, 64) X(128, 64) X(64, 32) X(32, 16)

int sifsr_conv_i8_generic_supported(int cin, int cout) {
  if (cin == 16 && cout == 1) return 1;
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

// The launch of a tensor-core entry for an (n,h,w,C) input, without
// launching: kind 0 sifsr_conv_i8_exact, 1 the same with the phase mean, 2
// sifsr_conv_i8_exact_dual, 3 sifsr_conv_i8_in1_split, 4 sifsr_conv_i8_in1,
// 5 the outlay (sifsr_conv_i8_outlay, sifsr_conv_i8_generic at 16 -> 1).
// Writes the persistent grid (blocks), the dynamic shared memory of a block
// in bytes and the number of tiles.
int sifsr_conv_i8_mma_shape(int kind, int n, int h, int w, int* blocks, int* smem, int* tiles) {
  if (kind == 0) return tc::entry_shape<BCEntry<1, false>>(n, h, w, blocks, smem, tiles);
  if (kind == 1) return tc::entry_shape<BCEntry<1, true>>(n, h, w, blocks, smem, tiles);
  if (kind == 2) return tc::entry_shape<BCEntry<2, false>>(n, h, w, blocks, smem, tiles);
  if (kind == 3) return tc::entry_shape<In1Entry<false>>(n, h, w, blocks, smem, tiles);
  if (kind == 4) return tc::entry_shape<In1Entry<true>>(n, h, w, blocks, smem, tiles);
  if (kind == 5) return tc::entry_shape<OutlayEntry>(n, h, w, blocks, smem, tiles);
  return (int)cudaErrorInvalidValue;
}

// lst, ndvi (N,H,W) int8 -> out (N,H,W,16) int8.
int sifsr_conv_i8_in1_split(const void* lst, const void* ndvi, const void* wt,
                            const void* scale, const void* bias, void* out, int n, int h,
                            int w, int relu, void* stream) {
  return In1Entry<false>::launch(lst, ndvi, wt, scale, bias, out, n, h, w, relu,
                                 static_cast<cudaStream_t>(stream));
}

// x (N,H,W,2) int8, channel-interleaved -> out (N,H,W,16) int8.
int sifsr_conv_i8_in1(const void* x, const void* wt, const void* scale, const void* bias,
                      void* out, int n, int h, int w, int relu, void* stream) {
  return In1Entry<true>::launch(x, nullptr, wt, scale, bias, out, n, h, w, relu,
                                static_cast<cudaStream_t>(stream));
}

// x (N,H,W,16) int8, wt (3,3,16,1), scale/bias one float each -> out (N,H,W) f32.
int sifsr_conv_i8_outlay(const void* x, const void* wt, const void* scale, const void* bias,
                         void* out, int n, int h, int w, void* stream) {
  return OutlayEntry::launch(static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                             static_cast<const float*>(scale), static_cast<const float*>(bias),
                             static_cast<float*>(out), n, h, w, 0,
                             static_cast<cudaStream_t>(stream));
}

int sifsr_conv_i8_generic(const void* x, const void* wt, const void* scale, const void* bias,
                          void* out, int n, int h, int w, int cin, int cout, int relu,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 16 && cout == 1)
    return OutlayEntry::launch(static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                               static_cast<const float*>(scale), static_cast<const float*>(bias),
                               static_cast<float*>(out), n, h, w, relu, s);
#define SIFSR_CASE(CI, CO) \
  if (cin == CI && cout == CO) return launch_generic<CI, CO>(x, wt, scale, bias, out, n, h, w, relu, s);
  SIFSR_GENERIC_SHAPES(SIFSR_CASE)
#undef SIFSR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
