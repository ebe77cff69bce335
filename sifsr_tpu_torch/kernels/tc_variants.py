"""Where the time of the tensor-core convs (kernels B-L, the outlay) goes, on the card.

    python -m sifsr_tpu_torch.kernels.tc_variants [--reps 7] [--only D,F]

Builds ``csrc/conv_px.cu`` and ``csrc/conv_i8.cu`` as they are and in
variants made by editing the source text (each edit must match exactly
once; a variant rebuilds the sources its edits touch, every source for an
edited header), then times kernels B (with and without the phase mean), C,
D, the outlay (F's entry), G (its three shapes, with and without the
residual), H (both shapes), J (both shapes), I (both shapes, both x2
tables) and K (both tables) at the serving shapes (batch 324), or those
whose case names start with one of ``--only``'s letters, every variant in
turns within one process (in
order, then in reverse); a timed repeat queues BURST calls back to back, so
that the wrapper's host work for one call overlaps the card's work on the
last and the time is the card's:

- ``built``: the source as it is;
- ``one_block``: one block an SM (registers uncapped) and 16-row source tiles
  for I: the tiling the built one was chosen against;
- ``m_seq``: J's warps accumulate the two m16 tiles of their row one after
  the other rather than together (half the accumulators, twice the B
  fragment loads);
- ``c16_rows``: B on 16-row output tiles (two rows a warp) in place of
  32-row ones, C on 32-row tiles in place of 16-row ones: the other tiling;
- ``c16_ring4``: B and C with four halo stages in place of three (one more
  tile's input in flight a block);
- ``c16_two_rows``: B's warps take two of their rows at a time (four m16
  tiles, twice the independent accumulator chains and registers) in place
  of one;
- ``prow_rows``: G and H on the other tiling: at 16 input channels 16-row
  tiles in place of 32-row ones, for G at 32 8-row tiles in place of
  16-row ones, for G at 64 and H at 32 16-row tiles (two units a warp) in
  place of 8-row ones;
- ``prow_ring``: G and H with more halo stages: four in place of three at
  16 input channels, four in place of two at 32 and three at 64;
- ``prow_blocks``: G and H at 32 and 64 input channels with the register cap
  of three blocks an SM in place of two at 32, of one (uncapped) at 64;
- ``in1_rows``: D and E on 16-row output tiles (two rows a warp) in place of
  32-row ones;
- ``in1_blocks``: D and E with the register cap of five blocks an SM in
  place of four;
- ``ol_ring``: the outlay with four halo stages in place of three;
- ``cvt``: the epilogues of B, C, D, G, H and the outlay with the conversion instructions
  (``__int2float_rn``, ``rintf`` and the float-to-int cast) in place of the
  exact float and integer forms (``i2f_small``, ``requant_bits``): the same
  values, another unit;
- ``no_mma``: each tensor-core product replaced by one integer operation on
  the same fragments (the ldmatrix loads stay): the time without the
  tensor-core work;
- ``no_halo``: the halo copies dropped (the kernels compute on whatever shared
  memory holds; D and E still write their halo buffers, from registers
  that hold no input): the time without the input traffic;
- ``no_store``: the output stores of D, E and the outlay dropped (the
  epilogue and its staging stay): the time without the output traffic;
- ``no_x2``: the x2 epilogue of I and K replaced by a copy of the centre tap
  to each output (the stores stay): the time without the upsample
  arithmetic. J has no x2; its ``no_x2`` row is the built code again, a
  reading of the noise.

A variant that leaves a kernel's code as built (the ``c16_*`` and ``cvt``
rows of I-L, the ``one_block``, ``m_seq`` and ``no_x2`` rows of B-H and the
outlay, the ``prow_*`` rows of all but G and H, the ``in1_*``, ``ol_ring``
and ``no_store`` rows of all but D and the outlay) reads the noise. The
outputs of ``built``, ``one_block``, ``m_seq``, ``c16_rows``, ``c16_ring4``,
``c16_two_rows``, the ``prow_*`` and ``in1_*`` variants, ``ol_ring`` and
``cvt`` are checked against the plain versions; the other variants' outputs
are meaningless and only timed. First it times the card on bare streams of
the 16-channel 256² output's size (``zero_``: 340 MB written; ``copy_``:
340 MB read and written), what a kernel whose output is its bytes can
reach. Prints a line per kernel and variant and, last, one JSON object of
the times with the card's name and power limit. Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from unittest import mock

import numpy as np
import torch

from sifsr_tpu_torch.kernels import _build, conv_i8, conv_px

N = 324
BURST = 5
VARIANTS = ("built", "one_block", "m_seq", "c16_rows", "c16_ring4", "c16_two_rows", "prow_rows",
            "prow_ring", "prow_blocks", "in1_rows", "in1_blocks", "ol_ring", "cvt",
            "no_mma", "no_halo", "no_store", "no_x2")
CHECKED = ("built", "one_block", "m_seq", "c16_rows", "c16_ring4", "c16_two_rows", "prow_rows",
           "prow_ring", "prow_blocks", "in1_rows", "in1_blocks", "ol_ring", "cvt")
SOURCES = ("conv_px.cu", "conv_i8.cu", "conv16.cuh", "conv_mma.cuh", "conv_tile.cuh")

# J's two m16 tiles a warp, accumulated together (as built) or one after
# the other (m_seq)
_DUAL_JOINT = """    const int8_t* sh = smem + L::OFF_HALO + (it % STAGES) * 2 * L::HALO;
    int ax[2][NT8][4] = {}, az[2][NT8][4] = {};
    tc::conv_mma<C, C, L::HWD, 2, NT8>(ax, sh, s_wx, p0, 0);
    tc::conv_mma<C, C, L::HWD, 2, NT8>(az, sh + L::HALO, s_wz, p0, 0);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int co = 8 * j + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int8_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float yx = __fmul_rn(__int2float_rn(ax[m][j][2 * hf + e]), s_sx[co + e]);
            const float yz = __fmul_rn(__int2float_rn(az[m][j][2 * hf + e]), s_sz[co + e]);
            q[e] = requant(__fadd_rn(__fadd_rn(yx, yz), s_b[co + e]), relu);
          }
          const int pix = 16 * m + g + 8 * hf;
          *reinterpret_cast<uint16_t*>(s_o + tc::swz<CH>(pix, co / 16) * 16 + co % 16) =
              tc::pack2(q[0], q[1]);
        }
      }
    __syncwarp();"""
_DUAL_SEQUENTIAL = """    const int8_t* sh = smem + L::OFF_HALO + (it % STAGES) * 2 * L::HALO;
    constexpr int MP = 1;
#pragma unroll 1
    for (int m0 = 0; m0 < 2; m0 += MP) {
      int p0[MP];  // halo pixel of this lane's ldmatrix row of each tile
#pragma unroll
      for (int m = 0; m < MP; ++m) p0[m] = row * L::HWD + 16 * (m0 + m) + tc::a_row();
      int ax[MP][NT8][4] = {}, az[MP][NT8][4] = {};
      tc::conv_mma<C, C, L::HWD, MP, NT8>(ax, sh, s_wx, p0, 0);
      tc::conv_mma<C, C, L::HWD, MP, NT8>(az, sh + L::HALO, s_wz, p0, 0);
#pragma unroll
      for (int m = 0; m < MP; ++m)
#pragma unroll
        for (int j = 0; j < NT8; ++j) {
          const int co = 8 * j + 2 * tq;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            int8_t q[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float yx = __fmul_rn(__int2float_rn(ax[m][j][2 * hf + e]), s_sx[co + e]);
              const float yz = __fmul_rn(__int2float_rn(az[m][j][2 * hf + e]), s_sz[co + e]);
              q[e] = requant(__fadd_rn(__fadd_rn(yx, yz), s_b[co + e]), relu);
            }
            const int pix = 16 * (m0 + m) + g + 8 * hf;
            *reinterpret_cast<uint16_t*>(s_o + tc::swz<CH>(pix, co / 16) * 16 + co % 16) =
                tc::pack2(q[0], q[1]);
          }
        }
    }
    __syncwarp();"""

# (file, old text, new text) of each variant
_EDITS = {
    "built": [],
    "one_block": [
        ("conv_px.cu", "constexpr int dual_min_blocks(int c) { return c == 64 ? 1 : 2; }",
         "constexpr int dual_min_blocks(int) { return 1; }"),
        ("conv_px.cu", "constexpr int up2_rows(int cin) { return cin == 64 ? 8 : 16; }",
         "constexpr int up2_rows(int) { return 16; }"),
        ("conv_px.cu", "constexpr int UP2_MIN_BLOCKS = 2;", "constexpr int UP2_MIN_BLOCKS = 1;"),
    ],
    "m_seq": [
        ("conv_px.cu", _DUAL_JOINT, _DUAL_SEQUENTIAL),
        ("conv_px.cu",
         "  const int p0[2] = {row * L::HWD + tc::a_row(), "
         "row * L::HWD + 16 + tc::a_row()};\n", ""),
    ],
    "c16_rows": [
        ("conv_i8.cu", "constexpr int c16_rows(int nin) { return nin == 1 ? 32 : 16; }",
         "constexpr int c16_rows(int nin) { return nin == 1 ? 16 : 32; }"),
    ],
    "c16_ring4": [
        ("conv_i8.cu", "constexpr int C16_RING = 3;", "constexpr int C16_RING = 4;"),
    ],
    "c16_two_rows": [
        ("conv_i8.cu", "constexpr int c16_rows_a_pass(int) { return 1; }",
         "constexpr int c16_rows_a_pass(int nin) { return nin == 1 ? 2 : 1; }"),
    ],
    "prow_rows": [
        ("conv_px.cu", "constexpr int PROW16_ROWS = 32;", "constexpr int PROW16_ROWS = 16;"),
        ("conv_px.cu",
         "constexpr int prow_rows(int cin, int cout) { return cin == 32 && cout == 32 ? 16 : 8; }",
         "constexpr int prow_rows(int cin, int cout) { return cin == 32 && cout == 32 ? 8 : 16; }"),
    ],
    "prow_ring": [
        ("conv_px.cu", "constexpr int PROW16_RING = 3;", "constexpr int PROW16_RING = 4;"),
        ("conv_px.cu", "constexpr int prow_ring(int) { return 2; }",
         "constexpr int prow_ring(int cin) { return cin == 64 ? 3 : 4; }"),
    ],
    "prow_blocks": [
        ("conv_px.cu", "constexpr int prow_blocks(int) { return 2; }",
         "constexpr int prow_blocks(int cin) { return cin == 64 ? 1 : 3; }"),
    ],
    "in1_rows": [
        ("conv_i8.cu", "constexpr int IN1_ROWS = 32;", "constexpr int IN1_ROWS = 16;"),
    ],
    "in1_blocks": [
        ("conv_i8.cu", "constexpr int IN1_MIN_BLOCKS = 4;", "constexpr int IN1_MIN_BLOCKS = 5;"),
    ],
    "ol_ring": [
        ("conv_i8.cu", "constexpr int OL_RING = 3;", "constexpr int OL_RING = 4;"),
    ],
    "cvt": [
        ("conv_mma.cuh",
         "  return __fsub_rn(__int_as_float(bits), 12582912.f);",
         "  return __int2float_rn(bits - I2F_BIAS);"),
        ("conv_mma.cuh",
         """  y = fminf(fmaxf(y, relu ? 0.f : -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, 12582912.f));""",
         """  if (relu) y = fmaxf(y, 0.f);
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(y), -127.f), 127.f);"""),
    ],
    "no_mma": [
        ("conv_mma.cuh",
         '''  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
         '''  d[0] += (int)(a[0] ^ b0);
  d[1] += (int)(a[1] ^ b1);
  d[2] += (int)a[2];
  d[3] += (int)a[3];'''),
        ("conv_mma.cuh",
         '''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));''',
         '''  d[0] += (int)(a[0] ^ b);
  d[1] += (int)a[1];'''),
    ],
    "no_halo": [
        ("conv_mma.cuh",
         "    cp_async16(base + swz<CH>(p, c) * 16, "
         "x + (((size_t)n * h + gy) * w + gx) * C + c * 16);",
         "    (void)base, (void)gy, (void)gx;"),
        ("conv_i8.cu",
         """        if constexpr (INTERLEAVED)
          pf[k] = __ldg(reinterpret_cast<const uint16_t*>(lst) + o);
        else
          pf[k] = (uint32_t)(uint8_t)__ldg(lst + o) | (uint32_t)(uint8_t)__ldg(ndvi + o) << 8;""",
         "        pf[k] = (uint32_t)o;"),
    ],
    "no_store": [
        ("conv_i8.cu", """      if (gy < h && gx < w)
        *reinterpret_cast<uint4*>(out + (((size_t)img * h + gy) * w + gx) * 16) =""",
         """      if (gy < h && gx < w && relu == 7)
        *reinterpret_cast<uint4*>(out + (((size_t)img * h + gy) * w + gx) * 16) ="""),
        ("conv16.cuh", "      if (gy < h && gx < w) out[((size_t)img * h + gy) * w + gx] = y;",
         "      if (gy < h && gx < w && relu == 7) out[((size_t)img * h + gy) * w + gx] = y;"),
    ],
    "no_x2": [
        ("conv_px.cu",
         "    const int8_t* base = s_q + ((k - sy0) * RW + (l - sx0)) * COUT + c0;\n",
         """    const int8_t* base = s_q + ((k - sy0) * RW + (l - sx0)) * COUT + c0;
    if (true) {
      int8_t q0[16];
      unpack16(q0, *reinterpret_cast<const uint4*>(base + (RW + 1) * COUT));
      store16(out + (((size_t)n * oh + oy) * ow + ox) * COUT + c0, q0);
      continue;
    }
"""),
    ],
}


def build_variants() -> dict[str, dict]:
    """Write and compile every variant in parallel; returns, for each, the
    bound libraries {'conv_px': ..., 'conv_i8': ...} (the built ones where
    the variant leaves a source as it is)."""
    root = _build.BUILD_DIR / "variants"
    sources = {name: (_build.CSRC / name).read_text() for name in SOURCES}
    procs = {}
    for name, edits in _EDITS.items():
        texts = dict(sources)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: the edit of {fname} does not match once")
            texts[fname] = texts[fname].replace(old, new)
        touched = {fname for fname, _, _ in edits}
        rebuild = [f for f in SOURCES if f.endswith(".cu") and
                   (name == "built" or f in touched or any(t.endswith(".cuh") for t in touched))]
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        for f in rebuild:
            lib = d / f.replace(".cu", ".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / f)]
            procs[name, f] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    paths = {}
    for (name, f), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {f} in variant {name} failed:\n{log}")
        paths[name, f] = lib
    binders = {"conv_px.cu": conv_px.bind, "conv_i8.cu": conv_i8.bind}
    libs = {}
    for name in _EDITS:
        libs[name] = {f[:-3]: binders[f](ctypes.CDLL(str(paths.get((name, f), paths["built", f]))))
                      for f in binders}
    return libs


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def _time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call over ``reps`` repeats of BURST
    calls."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BURST)
    return float(np.median(times))


def _streams(dev, reps: int) -> dict:
    """Times of bare streams of a (N,256,256,16) int8 tensor: ``zero_`` (340
    MB written) and ``copy_`` into another (340 MB read, 340 MB written)."""
    a = torch.empty((N, 256, 256, 16), dtype=torch.int8, device=dev)
    b = torch.empty_like(a)
    out = {"zero_": _time_ms(a.zero_, reps), "copy_": _time_ms(lambda: b.copy_(a), reps)}
    del a, b
    return out


def _cases(dev, rng):
    """(name, kernel call, plain call) at the serving shapes, inputs as
    chip_smoke.py makes them."""

    def conv_args(cin, cout, hw):
        w = rng.integers(-60, 61, (3, 3, cin, cout), dtype=np.int8)
        acc_rms = 73.0 * np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1, 2)))
        x = rng.integers(-127, 128, (N, hw, hw, cin), dtype=np.int8)
        return [torch.from_numpy(a).to(dev) for a in
                (x, w, (40.0 / acc_rms).astype(np.float32),
                 rng.normal(0.0, 4.0, cout).astype(np.float32))]

    x2, w1, s1, b1 = conv_args(2, 16, 256)
    planes = (x2[..., 0].contiguous(), x2[..., 1].contiguous())
    del x2
    d_args = (*planes, w1, s1, b1)
    yield ("D 2->16 256²", lambda a=d_args: conv_i8.conv_i8_in1_split(*a),
           lambda a=d_args: conv_i8.conv_i8_in1_split_plain(*a))
    ol_args = conv_args(16, 1, 256)
    yield ("F outlay 16->1 256²", lambda a=ol_args: conv_i8.conv_i8_outlay(*a),
           lambda a=ol_args: conv_i8.conv_i8_outlay_plain(*a))

    b_args = conv_args(16, 16, 256)
    pm = float(np.float32(0.9) / np.float32(4.0))
    yield ("B 16ch 256² phase mean", lambda a=b_args: conv_i8.conv_i8_exact(*a, pm_scale=pm),
           lambda a=b_args: conv_i8.conv_i8_exact_plain(*a, pm_scale=pm))
    yield ("B 16ch 256²", lambda a=b_args: conv_i8.conv_i8_exact(*a),
           lambda a=b_args: conv_i8.conv_i8_exact_plain(*a))
    x, wx, sx, b = b_args
    z, wz, sz, _ = conv_args(16, 16, 256)
    c_args = (x, z, wx, wz, sx, sz, b)
    yield ("C 16ch 256²", lambda a=c_args: conv_i8.conv_i8_exact_dual(*a),
           lambda a=c_args: conv_i8.conv_i8_exact_dual_plain(*a))

    for hw, c in ((128, 16), (64, 32), (32, 64)):
        args = conv_args(c, c, hw)
        v0 = torch.from_numpy(rng.integers(-127, 128, (N, hw, hw, c), dtype=np.int8)).to(dev)
        yield (f"G {c}ch {hw}²", lambda a=args: conv_px.conv_prow(*a),
               lambda a=args: conv_px.conv_prow_plain(*a))
        yield (f"G {c}ch {hw}² residual",
               lambda a=args, v=v0: conv_px.conv_prow(*a, residual=v, res_sc=0.71),
               lambda a=args, v=v0: conv_px.conv_prow_plain(*a, residual=v, res_sc=0.71))
    for hw, cin, cout in ((128, 16, 32), (64, 32, 64)):
        args = conv_args(cin, cout, hw)
        yield (f"H {cin}->{cout} {hw}²", lambda a=args: conv_px.conv_prow_split_pool(*a, 0.19),
               lambda a=args: conv_px.conv_prow_split_pool_plain(*a, 0.19))

    for hw, c in ((64, 64), (128, 32)):
        x, wx, sx, b = conv_args(c, c, hw)
        z, wz, sz, _ = conv_args(c, c, hw)
        args = (x, z, wx, wz, sx, sz, b)
        yield (f"J {c}ch {hw}²", lambda a=args: conv_px.conv_prow_dual_planes(*a),
               lambda a=args: conv_px.conv_prow_dual_planes_plain(*a))
    for hw, cin, cout in ((32, 64, 64), (64, 64, 32), (128, 32, 16)):
        args = conv_args(cin, cout, hw)
        kernel = conv_px.conv_prow_up2_pack if cout == 16 else conv_px.conv_prow_up2
        for table, make in (("mxu", conv_px.up2_coeffs_mxu), ("vpu", conv_px.up2_coeffs)):
            r, c, inv = make(hw, hw, 0.05, 0.0625)
            tabs = (torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev), inv)
            yield (f"{'K' if cout == 16 else 'I'} {cin}->{cout} {hw}² {table}",
                   lambda a=args, t=tabs, k=kernel: k(*a, *t),
                   lambda a=args, t=tabs: conv_px.conv_prow_up2_plain(*a, *t))


def main(reps: int = 7, only: str = "") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tc_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    streams = _streams(dev, reps)
    nbytes = N * 256 * 256 * 16
    rates = {k: (1 if k == "zero_" else 2) * nbytes / t / 1e9 for k, t in streams.items()}
    print("streams: " + ", ".join(f"{k} {t:.4f} ms ({rates[k]:.2f} TB/s)"
                                  for k, t in streams.items()), flush=True)
    result = {}
    for name, kern, plain in _cases(dev, np.random.default_rng(0)):
        if only and name[0] not in only.split(","):
            continue
        want = plain()
        times = {v: [] for v in VARIANTS}
        for v in VARIANTS + VARIANTS[::-1]:
            with mock.patch.object(conv_px, "_lib", lambda lib=libs[v]["conv_px"]: lib), \
                    mock.patch.object(conv_i8, "_lib", lambda lib=libs[v]["conv_i8"]: lib):
                if v in CHECKED and not times[v] and not _same(kern(), want):
                    raise AssertionError(f"{name}: variant {v} differs from the plain version")
                times[v].append(_time_ms(kern, reps))
        del want
        result[name] = times
        print(f"{name}: " + ", ".join(f"{v} {t[0]:.4f} / {t[1]:.4f} ms" for v, t in times.items()),
              flush=True)
    print(json.dumps({"device": smi.splitlines()[0], "batch": N, "reps": reps, "burst": BURST,
                      "streams_ms": streams, "ms_two_turns": result}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=7, help="timed repeats a median is taken over")
    parser.add_argument("--only", default="",
                        help="comma-separated first letters of the cases to time (default: all)")
    args = parser.parse_args()
    main(args.reps, args.only)
