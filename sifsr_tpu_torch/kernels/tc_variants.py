"""Where the time of the tensor-core convs (kernels I, J, K, L) goes, on the card.

    python -m sifsr_tpu_torch.kernels.tc_variants [--reps 7]

Builds ``csrc/conv_px.cu`` as it is and in variants made by editing its
source text (each edit must match exactly once), then times kernels J (both
shapes), I (both shapes, both x2 tables) and K (both tables) at the serving
shapes (batch 324), every variant in turns within one process (in order, then
in reverse):

- ``built``: the source as it is;
- ``one_block``: one block an SM (registers uncapped) and 16-row source tiles
  for I: the tiling the built one was chosen against;
- ``m_seq``: J's warps accumulate the two m16 tiles of their row one after
  the other rather than together (half the accumulators, twice the B
  fragment loads);
- ``no_mma``: each tensor-core product replaced by one integer operation on
  the same fragments (the ldmatrix loads stay): the time without the
  tensor-core work;
- ``no_halo``: the halo copies dropped (the kernels compute on whatever shared
  memory holds): the time without the input traffic;
- ``no_x2``: the x2 epilogue of I and K replaced by a copy of the centre tap
  to each output (the stores stay): the time without the upsample
  arithmetic. J has no x2; its ``no_x2`` row is the built code again, a
  reading of the noise.

The outputs of ``built``, ``one_block`` and ``m_seq`` are checked against the plain
versions; the other variants' outputs are meaningless and only timed. Prints
a line per kernel and variant and, last, one JSON object of the times with
the card's name and power limit. Needs the card and nvcc.
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

from sifsr_tpu_torch.kernels import _build, conv_px

N = 324
VARIANTS = ("built", "one_block", "m_seq", "no_mma", "no_halo", "no_x2")

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
    ],
    "no_halo": [
        ("conv_mma.cuh",
         "    cp_async16(base + swz<CH>(p, c) * 16, "
         "x + (((size_t)n * h + gy) * w + gx) * C + c * 16);",
         "    (void)base, (void)gy, (void)gx;"),
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


def build_variants() -> dict[str, ctypes.CDLL]:
    """Write and compile every variant in parallel; returns the bound libraries."""
    root = _build.BUILD_DIR / "variants"
    sources = {p.name: p.read_text() for p in
               (_build.CSRC / "conv_px.cu", _build.CSRC / "conv_mma.cuh",
                _build.CSRC / "conv_tile.cuh")}
    procs = {}
    for name, edits in _EDITS.items():
        texts = dict(sources)
        for fname, old, new in edits:
            if texts[fname].count(old) != 1:
                raise RuntimeError(f"variant {name}: the edit of {fname} does not match once")
            texts[fname] = texts[fname].replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "conv_px.so"),
               str(d / "conv_px.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{log}")
        libs[name] = conv_px.bind(ctypes.CDLL(str(root / name / "conv_px.so")))
    return libs


def _time_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def main(reps: int = 7) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tc_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    result = {}
    for name, kern, plain in _cases(dev, np.random.default_rng(0)):
        want = plain()
        times = {v: [] for v in VARIANTS}
        for v in VARIANTS + VARIANTS[::-1]:
            with mock.patch.object(conv_px, "_lib", lambda lib=libs[v]: lib):
                if v in ("built", "one_block", "m_seq") and not times[v]:
                    if not torch.equal(kern(), want):
                        raise AssertionError(f"{name}: variant {v} differs from the plain version")
                times[v].append(_time_ms(kern, reps))
        del want
        result[name] = times
        print(f"{name}: " + ", ".join(f"{v} {t[0]:.4f} / {t[1]:.4f} ms" for v, t in times.items()),
              flush=True)
    print(json.dumps({"device": smi.splitlines()[0], "batch": N, "reps": reps,
                      "ms_two_turns": result}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=7, help="timed calls a median is taken over")
    main(parser.parse_args().reps)
