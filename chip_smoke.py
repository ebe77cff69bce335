#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``sifsr_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no result line is printed then):

1. device: the card's name and power limit (nvidia-smi);
2. build: every ``sifsr_tpu_torch/csrc/*.cu`` by nvcc for sm_90a, in
   parallel; ptxas's registers, spills and stack of the tensor-core kernels
   (B-L and the outlay: 22 instances);
3. kernels: each hand-written kernel of the int8 serving paths at the
   shapes the paths give it (batch 324), held against its plain PyTorch
   version on the same seeded inputs: the outputs must be identical (int8 and
   the generic conv's float32 alike). Kernel E (conv_i8_in1) must also equal
   D on the de-interleaved planes, F (conv_i8_outlay) the generic conv, L
   (conv_prow_dual) its plain version at both shapes, and I and K with the
   float32 tables of up2_impl='vpu' both their plain chain and kernel A with
   in_scale on the conv's int8 output; CUDA-event times of kernel and plain
   version, the least time the card could take (bytes or operations), and,
   for kernel A, of the PyTorch interpolate calls that compute its float
   function (and each of A's two calls on its own: kernel ms, bytes bound,
   share of the bytes rate, library ms, in the entry's ``per_call``); for
   every int8 conv (B-L and the generic conv) the time of
   ``torch._int_mm`` over the im2col'd product at the same shapes (the
   product alone: M = N*H*W, K = 9*C, N = C_out, once per input for C, J
   and L; K and N zero-padded to _int_mm's multiples of 8 where a shape
   needs it, D's K = 18 to 24 and the outlay's N = 1 to 8; the im2col is
   built beforehand and the yardstick checked against the exact conv on one
   image), and for B-L and the outlay their persistent grid and shared
   memory a block; each call's share of the bytes rate. First the card's
   launch floor (a one-element ``zero_`` back to back in bursts of 20,
   ``floor_ms`` in every entry): a call that moves under 1 MB is judged
   against the larger of it and its bytes bound. The
   float kernels of the training losses at training batch 32:
   fused_psf_downscale forward at (32,256,256) and backward (32,64,64) ->
   (32,256,256) within max|d| 1e-5 of the plain version evaluated in
   float64 (bound: the bytes of the stream and the band, the banded
   operations), fused_norm_l4 at (32,256,256) and (32,64,64) within 1e-6
   relative, each beside the PyTorch chain that computes the same function
   (two matmuls and an add; pow/avg_pool2d/pow), and M beside one PyTorch
   kernel that moves the same bytes (avg_pool2d, nearest x4); value (1e-5)
   and gradient (rtol 1e-4 / atol 1e-6) of huber(fused_psf_downscale(x), t)
   through autograd against the plain chain; then M past the recipes' shapes
   (factor 16 at (4,256,256), factor 8 at (2,1024,1024), factor 2 at
   (1,2048,2048)) through the wrapper: value and gradient within 1e-5 of
   float64, one launch each way;
4. float anchor: ModelB2 in float32 (TF32 off) vs the reference torch
   outputs in golden/ at rtol 1e-4 / atol 5e-5;
5. whole granule: a seeded synthetic 1200² LST / 4800² NDVI granule through
   ``predict_granule`` at batch 324 with the float32 step, the bf16 step
   (``predict_granule``'s default, fused pads; the float32 step defaults to
   explicit pads), the int8 step of
   ``make_quantized_step(..., use_pallas=True)`` (mid='prow', kernels G-K)
   and the int8 ``mid='xla'`` step on the same parameters. The bf16 mosaic
   must stay within RMSE 0.1 K / max 0.5 K of the float32 one (the bound of
   the port's CPU test of the bf16 step); each int8 mosaic within RMSE 0.3 K
   / max 1 K, inside 250-350 K. The launch counters, zeroed just before each
   int8 run, must show exactly the kernels of that path, per batch:
   prow: upsample_phases 1, conv_i8_in1_split 1, conv_i8_exact 2,
   conv_i8_exact_dual 1, conv_i8_generic 1, conv_prow 6,
   conv_prow_split_pool 2, conv_prow_up2 2, conv_prow_dual_planes 2,
   conv_prow_up2_pack 1; xla: upsample_phases 2, conv_i8_in1_split 1,
   conv_i8_exact 2, conv_i8_exact_dual 1, conv_i8_generic 14. Then the
   comparison steps on the same granule: kernels='alt' (E 1, F 1, L 2 in
   place of D, the generic conv and J), whose mosaic must be identical to
   the prow one; up2_impl='vpu' parameters (same counts as prow, same gates,
   differences from the mxu mosaic logged); the plain int8 step of
   ``predict --int8`` (conv_i8_generic 18, one for every conv of the
   folded model; same gates). Step times of all,
   and of the float steps with both pad forms. The granule modes with the
   int8, bf16 and float32 steps: each mode identical to the host pipeline on
   the same wire; ``wire='int'`` within each step's own gate of the float32
   mosaic, and, on the granule rounded to the wire's steps (LST 0.02 K, NDVI
   1e-4, what MODIS products hold), within 0.0101 K of the float wire for
   every step: half the 0.02 K output step and a float32 ulp;
6. files: the granule written as a MOD21A1D-like and a MOD09GQ-like HDF4 pair
   (the port's writer) and as a GeoTIFF pair; ``cli.predict.main`` once per
   serving flag (default bf16, --f32, --int8, --pallas, --pallas --up2-impl
   vpu) and, under --pallas, per --mode (host_pipeline, device_tiling,
   device_tiling_wire, auto): each prediction.tiff read back, 4608², with
   the NDVI's geotransform, equal to ``predict_granule`` on the decoded
   arrays in the same mode (identical; ``--f32 --wire int`` within 0.012 K of
   the float wire: half the 0.02 K output step plus the response to NDVI
   rounded to 1e-4; ``--pallas --wire int`` within 0.0101 K of ``--pallas``
   on a GeoTIFF pair rounded to the wire's steps); ``cli.serve.main --once --pallas`` on a
   spool with two good jobs, a missing file and broken JSON: two rasters
   identical to predict's, two failed/*.err, one calibration, exactly two
   granules' worth of launches. Wall seconds per command;
7. golden train step: one predef_filters step from weights/modelB_1009 on
   golden/train_step_predef.npz (batch 4, TF32 off), whose ds_loss runs
   fused_psf_downscale forward and backward: losses within 5e-5 of the torch
   reference, post-step parameters 0.999-quantile < 1e-4 and max < 1e-3 (and
   < 2e-5 wherever |gradient| >= 1e-6, where Adam's first update is well
   conditioned), BN running statistics < 5e-5;
8. training: two epochs of each recipe through ``train.loop.train_loop`` at
   full width and paramsB.json's hyperparameters (batch 32, lr 1e-3, alpha
   0.99, gamma -0.5) on make_synthetic_dataset(64, seed=1) / (32, seed=2):
   finite losses, exact launch counts per recipe (predef_filters and
   gradftm: fused_psf_downscale 6 forward (4 train + 2 validation batches)
   and 4 backward; scale_invariance: none of those, fused_norm_l4 6, once
   per batch degradation), and ``save_final`` read back equal by
   ``cli.predict.load_variables``. Then the median device time of
   one train step at batch 32 with and without step metrics, samples/s and
   peak memory. ``--profile`` adds a torch.profiler table of three steps and
   the time of the step under TF32, under bf16 autocast and with remat.

The second-to-last line is the kernels JSON, the last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one, or without the repository beside it.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 324                      # predict's batch: one 1200² granule = 18x18 blocks
TRAIN_BATCH = 32             # paramsB.json
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def digest(a) -> str:
    """A short sha256 of an array's bytes: two runs' mosaics and rasters are
    identical exactly where their digests are."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def time_ms(torch, fn, reps: int, burst: int = 1) -> float:
    """Median CUDA-event time of one call, after one warm-up call.

    burst > 1 is for kernels that take less than the tens of microseconds a
    launch through Python costs the host: the events bracket ``burst`` calls
    queued behind enough matrix products to outlast the host's enqueueing,
    so that they run back to back, and the time is theirs over ``burst``
    (inputs warm in L2). A repeat in which the card caught up with the host
    before the last call was queued is made again behind twice the
    products; if that keeps happening the repeat counts as it is (it then
    holds idle gaps, and the log says so)."""
    fn()
    if burst == 1:
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    blocker = torch.ones((4096, 4096), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(burst):
        fn()
    host_s = time.perf_counter() - t0          # enqueueing only: nothing waits here
    t0 = time.perf_counter()
    torch.matmul(blocker, blocker)
    torch.cuda.synchronize()
    blocker_s = time.perf_counter() - t0
    n_block = int(3 * host_s / blocker_s) + 2
    times, retries = [], 0
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(n_block):
            torch.matmul(blocker, blocker)
        start.record()
        for _ in range(burst):
            fn()
        queued_behind = not start.query()
        end.record()
        end.synchronize()
        if not queued_behind and retries < 6:
            retries += 1
            n_block *= 2
            continue
        if not queued_behind:
            log("  (burst timing: the card caught up with the host; this repeat holds idle gaps)")
        times.append(start.elapsed_time(end) / burst)
    return float(np.median(times))


def main(profile: bool = False) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    sys.path.insert(0, ROOT)
    from sifsr_tpu_torch import kernels as K
    from sifsr_tpu_torch.cli.predict import load_variables, make_quantized_step
    from sifsr_tpu_torch.data.statistics import Statistics
    from sifsr_tpu_torch.inference import predict_granule
    import torch.nn.functional as F

    from sifsr_tpu_torch.kernels import _build, conv_i8, conv_px, fused_ops, resize_phases
    from sifsr_tpu_torch.ops import psf
    from sifsr_tpu_torch.models.int8_serving import make_int8_sr_step
    from sifsr_tpu_torch.cli import predict as cli_predict, serve as cli_serve
    from sifsr_tpu_torch.geo.hdf4 import write_hdf4_sds
    from sifsr_tpu_torch.geo.tiff import read_geotiff, write_geotiff
    from sifsr_tpu_torch.inference import (WIRE_LST_STEP, WIRE_NDVI_STEP, encode_wire,
                                           probe_link)
    from sifsr_tpu_torch.models.unet import ModelB2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    # (library, mangled name): the 16-channel kernel is instantiated in both
    ptxas = {(name, r["kernel"]): r for name in ("conv_px", "conv_i8")
             for r in _build.ptxas_report(name) if "_mma_kernel" in r["kernel"]}
    for (name, mangled), r in ptxas.items():
        log(f"ptxas {name} {demangle(mangled)}: {r['registers']} registers, {r['spill_stores']} B "
            f"spill stores, {r['spill_loads']} B spill loads, {r['stack']} B stack, "
            f"{r['smem_static']} B static shared memory")
    if len(ptxas) != 22:
        raise AssertionError(f"ptxas reported {len(ptxas)} tensor-core kernels, expected 22")
    # kernel A's two serving instances: int8 out, the phase form at 5 taps
    # (cubic x4, one channel) and the pixel form at 3 (the x2, 16 channels)
    for r in _build.ptxas_report("resize_phases"):
        if any(k in r["kernel"] for k in ("upsample_phases_kernelILb1ELi2ELi5E",
                                          "upsample_phases_kernelILb1ELi1ELi3E")):
            log(f"ptxas resize_phases {demangle(r['kernel'])}: {r['registers']} registers, "
                f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")

    # 3. kernels vs plain versions at serving shapes
    rng = np.random.default_rng(0)

    def i8(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(dev)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def conv_args(cin, cout, shape):
        """int8 input and weights with a per-channel dequantise scale that puts
        the outputs mid-range (|y| ~ 40), like a calibrated layer."""
        w = rng.integers(-60, 61, (3, 3, cin, cout), dtype=np.int8)
        acc_rms = 73.0 * np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 1, 2)))
        scale = f32(40.0 / acc_rms)
        bias = f32(rng.normal(0.0, 4.0, cout))
        return i8(shape + (cin,)), torch.from_numpy(w).to(dev), scale, bias

    def conv_bytes(n, h, w, cin, cout, out_itemsize):
        return n * h * w * (cin + cout * out_itemsize) + 9 * cin * cout + 8 * cout

    def conv_ops(n, h, w, cin, cout):
        return 2.0 * n * h * w * 9 * cin * cout

    entries = {}
    # the card's floor for one launch: a kernel that writes one float, timed
    # as the training kernels are; a kernel that moves under 1 MB is judged
    # against the larger of this and its bytes bound
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(torch, one.zero_, 10, burst=20)
    log(f"launch floor: {floor_ms:.4f} ms (a one-element zero_, back to back in bursts of 20)")

    def int8_ms(ops):
        return ops / INT8_OPS_PER_S * 1e3

    def check(name, calls, reps=10, plain_reps=2, library=None, tol=None, relative=False,
              burst=1, library_is=None, launch=None, per_call=False):
        """calls: [(kernel_fn, plain_fn, nbytes, ops_ms[, reference_fn])] -- the
        kernel's work in one batch, ops_ms its operations over the card's peak
        rate for their type. The kernel's output must be identical to
        reference_fn's (default: plain_fn's), or within ``tol`` of it (largest
        absolute difference, or largest difference relative to the reference
        value) where a tolerance is given. library: PyTorch calls computing
        the same function (timed only). burst: see time_ms; kernel, plain
        version and library are timed the same way, and the time of a single
        call through the wrapper, host overhead included, is logged beside.
        per_call: library[i] computes calls[i]'s function; the entry then
        also holds each call's own numbers (``per_call``)."""
        err, ms, plain_ms, b_ms, ops_ms = 0.0, 0.0, 0.0, 0.0, 0.0
        calls_ms = []
        for kern, plain, nbytes, o_ms, *ref in calls:
            got, want = kern(), (ref[0] if ref else plain)()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if g.shape != w.shape or (tol is None and g.dtype != w.dtype):
                    raise AssertionError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
                d = (g.to(torch.float64) - w.to(torch.float64)).abs()
                err = max(err, float((d / w.to(torch.float64).abs()).max() if relative else d.max()))
            del got, want
            k_ms = time_ms(torch, kern, reps, burst)
            p_ms = time_ms(torch, plain, plain_reps, burst)
            ms += k_ms
            plain_ms += p_ms
            calls_ms.append((k_ms, p_ms, nbytes / HBM_BYTES_PER_S * 1e3, o_ms))
            b_ms += nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms += o_ms
            small = "" if nbytes >= 1e6 else (
                f"; under 1 MB, judged against max(bytes bound, floor) "
                f"{max(nbytes / HBM_BYTES_PER_S * 1e3, floor_ms):.4f} ms "
                f"({max(nbytes / HBM_BYTES_PER_S * 1e3, floor_ms) / k_ms:.1%} of it)")
            log(f"  {name} call: {k_ms:.4f} ms (plain {p_ms:.4f} ms), bytes bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
                f"({nbytes / HBM_BYTES_PER_S * 1e3 / k_ms:.1%} of the bytes rate), ops bound "
                f"{o_ms:.4f} ms" + small
                + ("" if burst == 1 else f"; back to back in bursts of {burst}, a single call "
                   f"through the wrapper {time_ms(torch, kern, reps):.4f} ms"))
        if not err <= (tol or 0.0):
            raise AssertionError(f"{name}: kernel differs from its plain version, "
                                 f"{'relative' if relative else 'max|d|'} = {err} "
                                 f"(allowed {tol or 0.0})")
        lib_each = None if library is None else [time_ms(torch, f, reps, burst) for f in library]
        lib_ms = None if library is None else sum(lib_each)
        extra = {}
        if per_call:
            extra["per_call"] = [
                dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(c_b, c_o),
                     bound_by="bytes" if c_b >= c_o else "operations", bytes_bound_ms=c_b,
                     library_ms=l_ms)
                for (k_ms, p_ms, c_b, c_o), l_ms in zip(calls_ms, lib_each)]
            for i, c in enumerate(extra["per_call"]):
                log(f"  {name} call {i}: {c['ms']:.4f} ms, bytes bound {c['bytes_bound_ms']:.4f} ms "
                    f"({c['bytes_bound_ms'] / c['ms']:.1%} of the bytes rate), library "
                    f"{c['library_ms']:.4f} ms ({c['library_ms'] / c['ms']:.2f}x the kernel's time)")
        entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=max(b_ms, ops_ms),
                             bound_by="bytes" if b_ms >= ops_ms else "operations",
                             library_ms=lib_ms, calls=len(calls), floor_ms=floor_ms,
                             **({} if library_is is None else {"library_is": library_is}),
                             **({} if launch is None else {"launch": launch}), **extra)
        log(f"kernel {name}: {len(calls)} call(s)/batch, "
            + ("identical to plain; " if tol is None else f"error {err:.3g} (allowed {tol:g}); ")
            + f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {max(b_ms, ops_ms):.4f} ms"
            + ("" if lib_ms is None else f", library {lib_ms:.4f} ms ({library_is})") + ")")

    def im2col(x):
        """(N,H,W,C) int8 -> (N*H*W, 9*C) int8 rows of the replicate-padded
        3x3 neighbourhood, tap-major as the HWIO weights."""
        n, h, w, c = x.shape
        ry = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
        rx = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
        xp = x[:, ry][:, :, rx]
        cols = torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)
        return cols.reshape(n * h * w, 9 * c)

    def int_mm_product(x, w):
        """torch._int_mm over the im2col'd conv (the product alone), K = 9*C
        and N = C_out zero-padded to _int_mm's multiples of 8 where needed,
        checked against the exact conv of the first image; returns the timed
        call."""
        cols = im2col(x)
        k, cout = cols.shape[1], w.shape[-1]
        kp, np_ = -(-k // 8) * 8, -(-cout // 8) * 8
        a = cols
        if kp != k:
            a = torch.zeros((cols.shape[0], kp), dtype=torch.int8, device=dev)
            a[:, :k] = cols
        del cols
        wm = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
        wm[:k, :cout] = w.reshape(-1, cout)
        b = wm.t().contiguous().t()                         # (K, N), column-major
        h, wd = x.shape[1], x.shape[2]
        first = torch._int_mm(a[:h * wd], b)[:, :cout]
        if not torch.equal(first, conv_i8.conv3x3_i32(x[:1], w).reshape(h * wd, -1)):
            raise AssertionError("the _int_mm yardstick differs from the exact conv")
        return lambda: torch._int_mm(a, b)

    def mma_launch(kind, n, h, w, cin, cout):
        """The persistent launch of a tensor-core entry, with ptxas's account
        of its kernel, logged."""
        got = conv_px.tensor_core_launch(kind, n, h, w, cin, cout)
        # the library and the template arguments as the mangled names spell them
        res, pool = int(kind == "prow_res"), int(kind == "pool")
        key = {"dual": f"conv_dual_mma_kernelILi{cin}E",
               "up2": f"conv_up2_mma_kernelILi{cin}ELi{cout}ELb0E",
               "up2_vpu": f"conv_up2_mma_kernelILi{cin}ELi{cout}ELb1E",
               "exact": "conv16_mma_kernelILi1ELi16ELb0ELb0E",
               "exact_pm": "conv16_mma_kernelILi1ELi16ELb1ELb0E",
               "exact_dual": "conv16_mma_kernelILi2ELi16ELb0ELb0E",
               "in1_split": "conv_in1_mma_kernelILb0E", "in1": "conv_in1_mma_kernelILb1E",
               "outlay": "conv16_outlay_mma_kernelI"}.get(
            kind, (f"conv16_mma_kernelILi1ELi{cout}ELb{pool}ELb{res}E" if cin == 16 else
                   f"conv_prow_mma_kernelILi{cin}ELi{cout}ELb{res}ELb{pool}E"))
        lib = "conv_i8" if kind.startswith(("exact", "in1", "outlay")) else "conv_px"
        (mangled, rep), = [(k, v) for (name, k), v in ptxas.items() if name == lib and key in k]
        kname = demangle(mangled)
        got.update(kernel=kname, registers=rep["registers"], spill_stores=rep["spill_stores"],
                   spill_loads=rep["spill_loads"])
        log(f"  launch {kname} at ({n},{h},{w},{cin}): {got['blocks']} blocks of "
            f"{got['smem_bytes']} B shared memory over {got['tiles']} tiles; "
            f"{rep['registers']} registers, {rep['spill_stores']} B spilled")
        return got

    # A: cubic x4 of the normalised LST, align-corners x2 of ub2's output
    lst_n = f32(rng.normal(0.0, 1.5, (N, 64, 64, 1)))
    mid_out = f32(np.abs(rng.normal(0.0, 1.0, (N, 128, 128, 16))))

    def taps(size, factor, kind):
        deltas, rc, cc = resize_phases._tables(size, size, factor, kind)
        return int((rc != 0).sum()), int((cc != 0).sum())

    def up_call(x, factor, kind, scale):
        n, h, w, c = x.shape
        r_taps, c_taps = taps(h, factor, kind)
        ops = 2.0 * n * c * (r_taps * w + factor * h * c_taps)
        nbytes = x.numel() * 4 + n * factor * h * factor * w * c
        return (lambda: K.upsample_phases(x, factor, kind, scale=scale),
                lambda: resize_phases.upsample_phases_plain(x, factor, kind, scale),
                nbytes, ops / F32_OPS_PER_S * 1e3)

    # A's float function is F.interpolate's (checked on the CPU to float32
    # rounding); the library time leaves out the int8 quantise. Each call is
    # timed back to back in bursts of 20 (the cubic call moves 27 MB, a few
    # microseconds of the card's time beside ~20 us of host work a call) and
    # is also reported on its own, beside its own library call
    xa = mid_out.permute(0, 3, 1, 2)           # NCHW view of the NHWC tensor
    for shape, factor in ((lst_n.shape, 4), (mid_out.shape, 2)):
        rows, blocks, smem = resize_phases._launch_shape(*shape[1:], factor)
        log(f"  upsample_phases launch at {tuple(shape)}: {rows} output rows a block, "
            f"{N * blocks} blocks of {smem} B shared memory")
    check("upsample_phases", [up_call(lst_n, 4, "cubic", 0.02),
                              up_call(mid_out, 2, "linear_ac", 0.025)],
          library=[lambda: F.interpolate(lst_n.permute(0, 3, 1, 2), scale_factor=4,
                                         mode="bicubic", align_corners=False),
                   lambda: F.interpolate(xa, scale_factor=2, mode="bilinear",
                                         align_corners=True)],
          burst=20, per_call=True,
          library_is="F.interpolate bicubic x4 (NCHW view) + bilinear align-corners x2 "
                     "(channels-last view), float32 out")
    del xa, mid_out

    mm_words = "torch._int_mm over the im2col'd conv, the product alone"

    # D: inbloc.conv1, LST and NDVI int8 planes -> 16 channels at 256²
    x2, w1, sc1, b1 = conv_args(2, 16, (N, 256, 256))
    lst_q, ndvi_q = x2[..., 0].contiguous(), x2[..., 1].contiguous()
    d_product = int_mm_product(x2, w1)
    check("conv_i8_in1_split", [(
        lambda: K.conv_i8_in1_split(lst_q, ndvi_q, w1, sc1, b1),
        lambda: conv_i8.conv_i8_in1_split_plain(lst_q, ndvi_q, w1, sc1, b1),
        conv_bytes(N, 256, 256, 2, 16, 1), int8_ms(conv_ops(N, 256, 256, 2, 16)))],
        library=[d_product], library_is=mm_words + "; K 18 zero-padded to 24",
        launch=[mma_launch("in1_split", N, 256, 256, 2, 16)])
    # E: the same conv on the channel-interleaved tensor; identical to D
    check("conv_i8_in1", [(
        lambda: K.conv_i8_in1(x2, w1, sc1, b1),
        lambda: conv_i8.conv_i8_in1_plain(x2, w1, sc1, b1),
        conv_bytes(N, 256, 256, 2, 16, 1), int8_ms(conv_ops(N, 256, 256, 2, 16)))],
        library=[d_product], library_is=mm_words + "; K 18 zero-padded to 24",
        launch=[mma_launch("in1", N, 256, 256, 2, 16)])
    if not torch.equal(K.conv_i8_in1(x2, w1, sc1, b1),
                       K.conv_i8_in1_split(lst_q, ndvi_q, w1, sc1, b1)):
        raise AssertionError("conv_i8_in1 differs from conv_i8_in1_split")
    log("kernel conv_i8_in1: identical to conv_i8_in1_split on the de-interleaved planes")
    del x2, lst_q, ndvi_q, d_product

    # B: inbloc.conv2 with the fused phase mean, ub3.conv2 without
    x, w, sc, b = conv_args(16, 16, (N, 256, 256))
    pm_scale = float(np.float32(0.9) / np.float32(4.0))
    b_product = int_mm_product(x, w)
    check("conv_i8_exact", [
        (lambda: K.conv_i8_exact(x, w, sc, b, pm_scale=pm_scale),
         lambda: conv_i8.conv_i8_exact_plain(x, w, sc, b, pm_scale=pm_scale),
         conv_bytes(N, 256, 256, 16, 16, 1) + N * 128 * 128 * 16,
         int8_ms(conv_ops(N, 256, 256, 16, 16))),
        (lambda: K.conv_i8_exact(x, w, sc, b),
         lambda: conv_i8.conv_i8_exact_plain(x, w, sc, b),
         conv_bytes(N, 256, 256, 16, 16, 1), int8_ms(conv_ops(N, 256, 256, 16, 16)))],
        library=[b_product, b_product], library_is=mm_words + ", once per call",
        launch=[mma_launch("exact_pm", N, 256, 256, 16, 16),
                mma_launch("exact", N, 256, 256, 16, 16)])
    del b_product

    # C: ub3.conv1 over concat(up, s0)
    z, wz, scz, _ = conv_args(16, 16, (N, 256, 256))
    check("conv_i8_exact_dual", [(
        lambda: K.conv_i8_exact_dual(x, z, w, wz, sc, scz, b),
        lambda: conv_i8.conv_i8_exact_dual_plain(x, z, w, wz, sc, scz, b),
        N * 256 * 256 * (16 + 16 + 16) + 2 * 9 * 16 * 16 + 12 * 16,
        int8_ms(2 * conv_ops(N, 256, 256, 16, 16)))],
        library=[int_mm_product(x, w), int_mm_product(z, wz)],
        library_is=mm_words + ", once per input",
        launch=[mma_launch("exact_dual", N, 256, 256, 16, 16)])
    del x, z
    torch.cuda.empty_cache()

    # generic: the 13 mid-chain convs and the outlay of one batch
    mid_shapes = ([(128, 16, 16)] * 2 + [(128, 16, 32)] + [(64, 32, 32)] * 2 + [(64, 32, 64)]
                  + [(32, 64, 64)] * 3 + [(64, 128, 64), (64, 64, 32), (128, 64, 32),
                                          (128, 32, 16), (256, 16, 1)])
    generic_calls, generic_lib = [], []
    for hw, cin, cout in mid_shapes:
        gx, gw, gs, gb = conv_args(cin, cout, (N, hw, hw))
        relu = cout != 1
        generic_lib.append(int_mm_product(gx, gw))
        generic_calls.append((
            (lambda gx=gx, gw=gw, gs=gs, gb=gb, relu=relu: K.conv_i8_generic(gx, gw, gs, gb, relu)),
            (lambda gx=gx, gw=gw, gs=gs, gb=gb, relu=relu:
             conv_i8.conv_i8_generic_plain(gx, gw, gs, gb, relu)),
            conv_bytes(N, hw, hw, cin, cout, 4), int8_ms(conv_ops(N, hw, hw, cin, cout))))
    check("conv_i8_generic", generic_calls, reps=5, plain_reps=1, library=generic_lib,
          library_is=mm_words + "; the outlay's N 1 zero-padded to 8")
    # F: the outlay with the de-normalise folded into one scale and one bias;
    # identical to the generic conv on the same operands (gx.. are the
    # outlay's, the last of mid_shapes)
    ol_args = (gx, gw, gs, gb)
    check("conv_i8_outlay", [(
        lambda: K.conv_i8_outlay(*ol_args),
        lambda: conv_i8.conv_i8_outlay_plain(*ol_args),
        conv_bytes(N, 256, 256, 16, 1, 4), int8_ms(conv_ops(N, 256, 256, 16, 1)))],
        library=generic_lib[-1:], library_is=mm_words + "; N 1 zero-padded to 8",
        launch=[mma_launch("outlay", N, 256, 256, 16, 1)])
    if not torch.equal(K.conv_i8_outlay(*ol_args),
                       K.conv_i8_generic(*ol_args, relu=False)[..., 0]):
        raise AssertionError("conv_i8_outlay differs from conv_i8_generic")
    log(f"kernel conv_i8_outlay: identical to conv_i8_generic; the generic call at this shape "
        f"{time_ms(torch, lambda: K.conv_i8_generic(*ol_args, relu=False), 10):.4f} ms")
    del generic_calls, generic_lib, ol_args, gx, gw, gs, gb
    torch.cuda.empty_cache()

    # G: res.conv1 and res.conv2 (residual fused) of db1, db2, db3
    prow_calls, prow_lib, prow_launch = [], [], []
    for hw, c in ((128, 16), (64, 32), (32, 64)):
        gx, gw, gs, gb = conv_args(c, c, (N, hw, hw))
        v0 = i8((N, hw, hw, c))
        prow_lib += [int_mm_product(gx, gw)] * 2
        prow_launch += [mma_launch(k, N, hw, hw, c, c) for k in ("prow", "prow_res")]
        for res in (None, v0):
            kw = {} if res is None else dict(residual=res, res_sc=0.71)
            prow_calls.append((
                (lambda gx=gx, gw=gw, gs=gs, gb=gb, kw=kw: K.conv_prow(gx, gw, gs, gb, **kw)),
                (lambda gx=gx, gw=gw, gs=gs, gb=gb, kw=kw:
                 conv_px.conv_prow_plain(gx, gw, gs, gb, **kw)),
                conv_bytes(N, hw, hw, c, c, 1) + (0 if res is None else N * hw * hw * c),
                int8_ms(conv_ops(N, hw, hw, c, c))))
    check("conv_prow", prow_calls, reps=5, plain_reps=1, library=prow_lib,
          library_is=mm_words + ", once per call (no residual)", launch=prow_launch)
    del prow_calls, prow_lib

    # H: db1/db2 lastconv with the fused 2x2 pool
    pool_calls, pool_lib, pool_launch = [], [], []
    for hw, cin, cout in ((128, 16, 32), (64, 32, 64)):
        gx, gw, gs, gb = conv_args(cin, cout, (N, hw, hw))
        pool_lib.append(int_mm_product(gx, gw))
        pool_launch.append(mma_launch("pool", N, hw, hw, cin, cout))
        pool_calls.append((
            (lambda gx=gx, gw=gw, gs=gs, gb=gb: K.conv_prow_split_pool(gx, gw, gs, gb, 0.19)),
            (lambda gx=gx, gw=gw, gs=gs, gb=gb:
             conv_px.conv_prow_split_pool_plain(gx, gw, gs, gb, 0.19)),
            conv_bytes(N, hw, hw, cin, cout, 1) + N * hw * hw * cout // 4,
            int8_ms(conv_ops(N, hw, hw, cin, cout))))
    check("conv_prow_split_pool", pool_calls, reps=5, plain_reps=1, library=pool_lib,
          library_is=mm_words + " (no pool)", launch=pool_launch)
    del pool_calls, pool_lib

    up2_lib, up2_launch = {}, {}

    def up2_call(kernel, hw, cin, cout):
        """conv + requantise + align-corners x2: the conv's int8 operations
        and, at the float32 rate of the CUDA cores, the x2's integer
        multiply-adds (two row taps per source column, two column taps per
        output)."""
        gx, gw, gs, gb = conv_args(cin, cout, (N, hw, hw))
        up2_lib.setdefault(kernel.__name__, []).append(int_mm_product(gx, gw))
        up2_launch.setdefault(kernel.__name__, []).append(mma_launch("up2", N, hw, hw, cin, cout))
        rnum, cnum, inv = conv_px.up2_coeffs_mxu(hw, hw, 0.05, 0.06)
        tabs = (torch.from_numpy(rnum).to(dev), torch.from_numpy(cnum).to(dev), inv)
        up_ops = 2.0 * N * cout * (2 * (2 * hw) * hw + 2 * (2 * hw) * (2 * hw))
        return ((lambda: kernel(gx, gw, gs, gb, *tabs)),
                (lambda: conv_px.conv_prow_up2_plain(gx, gw, gs, gb, *tabs)),
                N * hw * hw * cin + N * 4 * hw * hw * cout + 9 * cin * cout + 8 * cout
                + 2 * 6 * hw * 4,
                int8_ms(conv_ops(N, hw, hw, cin, cout)) + up_ops / F32_OPS_PER_S * 1e3)

    # I: db3 lastconv (32² -> 64²) and ub1.conv2 (64² -> 128²)
    check("conv_prow_up2", [up2_call(K.conv_prow_up2, 32, 64, 64),
                            up2_call(K.conv_prow_up2, 64, 64, 32)], reps=5, plain_reps=1,
          library=up2_lib["conv_prow_up2"], library_is=mm_words,
          launch=up2_launch["conv_prow_up2"])
    # K: ub2.conv2 (128² -> 256²), the serving tail
    check("conv_prow_up2_pack", [up2_call(K.conv_prow_up2_pack, 128, 32, 16)],
          reps=5, plain_reps=1, library=up2_lib["conv_prow_up2_pack"], library_is=mm_words,
          launch=up2_launch["conv_prow_up2_pack"])
    del up2_lib

    def up2_vpu_call(kernel, hw, cin, cout):
        """The same with the float32 tables of up2_impl='vpu': the reference
        is kernel A with in_scale on the conv's int8 output (s_up is exact
        in float32, so both form the same 1/s_up), the plain chain is checked
        beside it; the x2 as float32 multiply-adds (two row taps per source
        value and phase, two column taps per output)."""
        s_mid, s_up = 0.05, 0.0625
        gx, gw, gs, gb = conv_args(cin, cout, (N, hw, hw))
        rc, cc, inv = conv_px.up2_coeffs(hw, hw, s_mid, s_up)
        tabs = (torch.from_numpy(rc).to(dev), torch.from_numpy(cc).to(dev), inv)
        up_ops = 2.0 * N * cout * (2 * (2 * hw) * hw + 2 * (2 * hw) * (2 * hw))
        plain = lambda: conv_px.conv_prow_up2_plain(gx, gw, gs, gb, *tabs)
        second = lambda: resize_phases.upsample_phases(
            conv_px.conv_prow_plain(gx, gw, gs, gb), 2, "linear_ac", scale=s_up, in_scale=s_mid)
        if not torch.equal(plain(), second()):
            raise AssertionError("the vpu plain chain differs from upsample_phases with in_scale")
        mid_f = conv_px.conv_prow_plain(gx, gw, gs, gb).permute(0, 3, 1, 2).float()
        vpu_launch.setdefault(kernel.__name__, []).append(
            mma_launch("up2_vpu", N, hw, hw, cin, cout))
        return ((lambda: kernel(gx, gw, gs, gb, *tabs)), plain,
                N * hw * hw * cin + N * 4 * hw * hw * cout + 9 * cin * cout + 8 * cout
                + 2 * 6 * hw * 4,
                int8_ms(conv_ops(N, hw, hw, cin, cout)) + up_ops / F32_OPS_PER_S * 1e3,
                second), (lambda: F.interpolate(mid_f, scale_factor=2, mode="bilinear",
                                                align_corners=True))

    x2_words = "F.interpolate bilinear align-corners x2 of the conv's output: the x2 alone"
    vpu_launch = {}
    calls_lib = [up2_vpu_call(K.conv_prow_up2, 32, 64, 64), up2_vpu_call(K.conv_prow_up2, 64, 64, 32)]
    check("conv_prow_up2[vpu]", [c for c, _ in calls_lib], reps=5, plain_reps=1,
          library=[f for _, f in calls_lib], library_is=x2_words,
          launch=vpu_launch["conv_prow_up2"])
    calls_lib = [up2_vpu_call(K.conv_prow_up2_pack, 128, 32, 16)]
    check("conv_prow_up2_pack[vpu]", [c for c, _ in calls_lib], reps=5, plain_reps=1,
          library=[f for _, f in calls_lib], library_is=x2_words,
          launch=vpu_launch["conv_prow_up2_pack"])
    del calls_lib
    torch.cuda.empty_cache()

    # J: ub1.conv1 over concat(up, s2), ub2.conv1 over concat(up, s1); L: the
    # same function under its own wrapper (the skip is one tensor in NHWC)
    dual_calls, l_calls, dual_lib, dual_launch = [], [], [], []
    for hw, c in ((64, 64), (128, 32)):
        gx, gwx, gsx, gb = conv_args(c, c, (N, hw, hw))
        gz, gwz, gsz, _ = conv_args(c, c, (N, hw, hw))
        args = (gx, gz, gwx, gwz, gsx, gsz, gb)
        dual_lib += [int_mm_product(gx, gwx), int_mm_product(gz, gwz)]
        dual_launch.append(mma_launch("dual", N, hw, hw, c, c))
        nbytes = N * hw * hw * 3 * c + 2 * 9 * c * c + 12 * c
        dual_calls.append((
            (lambda args=args: K.conv_prow_dual_planes(*args)),
            (lambda args=args: conv_px.conv_prow_dual_planes_plain(*args)),
            nbytes, int8_ms(2 * conv_ops(N, hw, hw, c, c))))
        l_calls.append((
            (lambda args=args: K.conv_prow_dual(*args)),
            (lambda args=args: conv_px.conv_prow_dual_plain(*args)),
            nbytes, int8_ms(2 * conv_ops(N, hw, hw, c, c))))
    check("conv_prow_dual_planes", dual_calls, reps=5, plain_reps=1, library=dual_lib,
          library_is=mm_words + ", once per input", launch=dual_launch)
    check("conv_prow_dual", l_calls, reps=5, plain_reps=1, library=dual_lib,
          library_is=mm_words + ", once per input", launch=dual_launch)
    del dual_calls, l_calls, dual_lib
    torch.cuda.empty_cache()

    # M: the ds-loss degradation, forward (32,256,256) -> (32,64,64) and its
    # backward (32,64,64) -> (32,256,256) through autograd, against the plain
    # version in float64. The kernel reads M as a band: its operations are
    # two for each nonzero of M and row of X (step 1) or of T (step 2), at
    # the CUDA cores' float32 rate; its bytes X or g in, Y or dx out, the
    # band and, forward, the constant
    mean_lst, std_lst = 295.0, 10.0
    B = TRAIN_BATCH
    xm = f32(rng.standard_normal((B, 256, 256)))
    gm = f32(rng.standard_normal((B, 64, 64)))
    m_mat, mt_mat, m_const = fused_ops._sandwich_constants(256, 4, 0.1, mean_lst, std_lst, dev)
    band_m, band_mt = fused_ops._sandwich_bands(256, 4, 0.1, dev)
    band_bytes = 4 * (band_m.coef.numel() + band_m.lo.numel())
    m_nonzeros = int((m_mat != 0).sum())
    sandwich_ops_ms = 2.0 * B * m_nonzeros * (256 + 64) / F32_OPS_PER_S * 1e3
    sandwich_bytes = 4 * (B * 256 * 256 + B * 64 * 64)
    log(f"kernel M's band: {band_m.coef.shape[1]} coefficients a row forward, "
        f"{band_mt.coef.shape[1]} backward; {m_nonzeros} nonzeros in M; "
        f"{2.0 * B * m_nonzeros * 320 / 1e6:.1f} MFLOP a call")
    check("fused_psf_downscale", [(
        lambda: fused_ops.fused_psf_downscale(xm, mean_lst, std_lst),
        lambda: fused_ops.fused_psf_downscale_plain(xm, mean_lst, std_lst),
        sandwich_bytes + 4 * 64 * 64 + band_bytes, sandwich_ops_ms,
        lambda: fused_ops.fused_psf_downscale_plain(xm.double(), mean_lst, std_lst))],
        reps=10, plain_reps=10, tol=1e-5, burst=20,
        library=[lambda: torch.matmul(torch.matmul(m_mat, xm), mt_mat) + m_const])

    xg = xm.clone().requires_grad_()
    y_kernel = fused_ops.fused_psf_downscale(xg, mean_lst, std_lst)
    y_plain = fused_ops.fused_psf_downscale_plain(xg, mean_lst, std_lst)
    x64 = xm.double().requires_grad_()
    y64 = fused_ops.fused_psf_downscale_plain(x64, mean_lst, std_lst)
    check("fused_psf_downscale_backward", [(
        lambda: torch.autograd.grad(y_kernel, xg, gm, retain_graph=True)[0],
        lambda: torch.autograd.grad(y_plain, xg, gm, retain_graph=True)[0],
        sandwich_bytes + 4 * (band_mt.coef.numel() + band_mt.lo.numel()), sandwich_ops_ms,
        lambda: torch.autograd.grad(y64, x64, gm.double(), retain_graph=True)[0])],
        reps=10, plain_reps=10, tol=1e-5, burst=20,
        library=[lambda: torch.matmul(torch.matmul(mt_mat, gm), m_mat)])
    del y_kernel, y_plain, y64, x64
    # one PyTorch kernel that moves the same bytes each way: what a plain
    # stream reaches here
    log(f"stream references (bursts of 20): avg_pool2d 4x4 of (32,256,256) (the forward's "
        f"bytes) {time_ms(torch, lambda: F.avg_pool2d(xm[:, None], 4), 10, 20):.4f} ms, "
        f"nearest x4 of (32,64,64) (the backward's bytes) "
        f"{time_ms(torch, lambda: F.interpolate(gm[:, None], scale_factor=4), 10, 20):.4f} ms, "
        f"avg_pool2d 4x4 of (32,64,64) "
        f"{time_ms(torch, lambda: F.avg_pool2d(gm[:, None], 4), 10, 20):.4f} ms")

    # value and gradient of huber(fused_psf_downscale(x), t) through autograd
    from sifsr_tpu_torch.losses.losses import huber
    tm = f32(rng.standard_normal((B, 64, 64)))
    xa_k, xa_p = xm.clone().requires_grad_(), xm.clone().requires_grad_()
    v_k = huber(fused_ops.fused_psf_downscale(xa_k, mean_lst, std_lst), tm)
    v_p = huber(fused_ops.fused_psf_downscale_plain(xa_p, mean_lst, std_lst), tm)
    v_k.backward()
    v_p.backward()
    dv = abs(float(v_k.detach()) - float(v_p.detach()))
    log(f"autograd: huber(fused_psf_downscale) value |d| {dv:.3g}, gradient max|d| "
        f"{float((xa_k.grad - xa_p.grad).abs().max()):.3g}")
    if not dv < 1e-5:
        raise AssertionError(f"fused_psf_downscale: loss value off the plain chain by {dv}")
    torch.testing.assert_close(xa_k.grad, xa_p.grad, rtol=1e-4, atol=1e-6)
    del xg, xa_k, xa_p

    # kernel M past the recipes' shapes: a band of 36 (factor 16 at 256²),
    # rows of X staged in chunks of columns (1024² at factor 8, 2048² at
    # factor 2), value and gradient against float64
    for n_, size_, factor_ in ((4, 256, 16), (2, 1024, 8), (1, 2048, 2)):
        xr = f32(rng.standard_normal((n_, size_, size_))).requires_grad_()
        xr64 = xr.detach().double().requires_grad_()
        gr = f32(rng.standard_normal((n_, size_ // factor_, size_ // factor_)))
        K.reset_launches()
        yr = fused_ops.fused_psf_downscale(xr, mean_lst, std_lst, factor=factor_)
        (dxr,) = torch.autograd.grad(yr, xr, gr)
        torch.cuda.synchronize()
        counts = (K.fused_psf_downscale.launches, K.fused_psf_downscale.backward_launches)
        yr64 = fused_ops.fused_psf_downscale_plain(xr64, mean_lst, std_lst, factor=factor_)
        (dxr64,) = torch.autograd.grad(yr64, xr64, gr.double())
        d_val = float((yr.double() - yr64).abs().max())
        d_grad = float((dxr.double() - dxr64).abs().max())
        band_m, band_mt = fused_ops._sandwich_bands(size_, factor_, 0.1, torch.device("cpu"))
        log(f"fused_psf_downscale at factor {factor_} on {tuple(xr.shape)}: launches "
            f"(forward, backward) {counts}; value max|d| {d_val:.3g} ({d_val / 1e-5:.1%} of "
            f"1e-5), gradient max|d| {d_grad:.3g} ({d_grad / 1e-5:.1%}) vs float64; band "
            f"{band_m.coef.shape[1]} / {band_mt.coef.shape[1]}, rows {band_m.rows} / "
            f"{band_mt.rows}, chunks of {band_m.chunk} / {band_mt.chunk} columns, "
            f"{len(band_m.tile_in)} / {len(band_mt.tile_in)} tiles")
        if counts != (1, 1) or not (d_val <= 1e-5 and d_grad <= 1e-5):
            raise AssertionError(f"kernel M at factor {factor_} on {size_}²: launches {counts}, "
                                 f"value {d_val}, gradient {d_grad}")
        del xr, xr64, gr, yr, dxr, yr64, dxr64
    # their cached operands (the plain chain's float64 matrices, M's constant
    # and bands) would otherwise stay on the card into phase 8's peak memory
    psf._matrix_tensor.cache_clear()
    fused_ops._renorm_constant.cache_clear()
    fused_ops._sandwich_bands.cache_clear()

    # N: un-normalise, x^4 block mean, 4th root at (32,256,256) and (32,64,64);
    # five float32 operations an input element, bound by bytes
    norm_calls = []
    for hw in (256, 64):
        xn = xm[:, :hw, :hw].contiguous()
        norm_calls.append((
            (lambda xn=xn: fused_ops.fused_norm_l4(xn, mean_lst, std_lst)),
            (lambda xn=xn: fused_ops.fused_norm_l4_plain(xn, mean_lst, std_lst)),
            4 * (B * hw * hw + B * hw * hw // 16), 5.0 * B * hw * hw / F32_OPS_PER_S * 1e3,
            (lambda xn=xn: fused_ops.fused_norm_l4_plain(xn.double(), mean_lst, std_lst))))
    check("fused_norm_l4", norm_calls, reps=10, plain_reps=10, tol=1e-6, relative=True, burst=20,
          library=[lambda: F.avg_pool2d((xm * std_lst + mean_lst).pow(4)[:, None], 4).pow(0.25),
                   lambda: F.avg_pool2d((xm[:, :64, :64] * std_lst + mean_lst).pow(4)[:, None],
                                        4).pow(0.25)])
    # with the re-normalisation the last step cancels the leading digits, so
    # the bound is taken on the un-normalised value
    got = fused_ops.fused_norm_l4(xm, mean_lst, std_lst, renorm=True).double() * std_lst + mean_lst
    want = fused_ops.fused_norm_l4_plain(xm.double(), mean_lst, std_lst)
    rel = float(((got - want).abs() / want).max())
    log(f"fused_norm_l4 renorm=True: relative error on the un-normalised value {rel:.3g}")
    if not rel <= 1e-6:
        raise AssertionError(f"fused_norm_l4(renorm=True): relative error {rel}")
    del norm_calls, xm, gm, got, want
    torch.cuda.empty_cache()

    # 4. float anchor vs the reference torch goldens
    variables = load_variables(os.path.join(ROOT, "weights", "modelB_1009"))
    model = ModelB2()
    model.load_state_dict(variables, strict=True)
    model = model.to(dev).eval()
    fx = np.load(os.path.join(ROOT, "golden", "modelB_forward_modelB_1009.npz"))
    for which in ("rand", "real"):
        xin = f32(fx[f"{which}_input"].transpose(0, 2, 3, 1))
        with torch.no_grad():
            got = model(xin).cpu().numpy().transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got, fx[f"{which}_output"], rtol=1e-4, atol=5e-5)
        log(f"float anchor {which}: max|d| vs golden {np.abs(got - fx[f'{which}_output']).max():.3g}")
    del model

    # 5. whole granule, float32 step and int8 step
    stats = Statistics.from_json(os.path.join(ROOT, "data", "statistics_testset.json"))
    lst, ndvi = synthetic_granule(np.random.default_rng(1))

    def run(granule=None, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict_granule(variables, *(granule or (lst, ndvi)), stats, batch_size=N,
                              device=dev, **kw)
        return out, time.perf_counter() - t

    run(compute_dtype=torch.float32)
    ref, t_f32 = run(compute_dtype=torch.float32)
    run()
    sr_bf16, t_bf16 = run()
    assert sr_bf16.shape == ref.shape and np.isfinite(sr_bf16).all()
    d = sr_bf16.astype(np.float64) - ref
    rmse, dmax = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
    log(f"granule: bf16 vs f32 RMSE {rmse:.4f} K, max {dmax:.4f} K")
    if not (rmse < 0.1 and dmax < 0.5):
        raise AssertionError(f"bf16 step off the float32 step: rmse {rmse}, max {dmax}")
    t = time.perf_counter()
    step, qparams = make_quantized_step(variables, lst, ndvi, stats, use_pallas=True, device=dev)
    t_cal = time.perf_counter() - t
    xla_step = make_int8_sr_step(stats, mid="xla", device=dev)
    n_blocks = (lst.shape[0] // 64) * (lst.shape[1] // 64)
    n_batches = -(-n_blocks // N)
    per_batch = {
        "prow": {"upsample_phases": 1, "conv_i8_in1_split": 1, "conv_i8_exact": 2,
                 "conv_i8_exact_dual": 1, "conv_i8_generic": 1, "conv_prow": 6,
                 "conv_prow_split_pool": 2, "conv_prow_up2": 2, "conv_prow_dual_planes": 2,
                 "conv_prow_up2_pack": 1},
        "xla": {"upsample_phases": 2, "conv_i8_in1_split": 1, "conv_i8_exact": 2,
                "conv_i8_exact_dual": 1, "conv_i8_generic": 14},
    }
    mosaic = (256 * (lst.shape[0] // 64), 256 * (lst.shape[1] // 64))  # partial blocks drop
    launches, wall = {}, {}
    for mid, int8_step in (("prow", step), ("xla", xla_step)):
        run(sr_step=int8_step, step_params=qparams)
        K.reset_launches()
        sr, wall[mid] = run(sr_step=int8_step, step_params=qparams)
        launches[mid] = {k.__name__: k.launches for k in K.KERNELS}
        want = {k.__name__: per_batch[mid].get(k.__name__, 0) * n_batches for k in K.KERNELS}
        if launches[mid] != want:
            raise AssertionError(f"{mid}: launches {launches[mid]}, expected {want}")
        assert ref.shape == sr.shape == mosaic, (ref.shape, sr.shape)
        assert np.isfinite(sr).all() and np.isfinite(ref).all()
        d = sr.astype(np.float64) - ref
        rmse, dmax = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
        log(f"granule: int8 ({mid}) vs f32 RMSE {rmse:.4f} K, max {dmax:.4f} K, "
            f"int8 range {sr.min():.2f}..{sr.max():.2f} K; launches {launches[mid]}; mosaic "
            f"sha256 {digest(sr)}")
        if not (rmse < 0.3 and dmax < 1.0 and sr.min() > 250.0 and sr.max() < 350.0
                and ref.min() > 250.0 and ref.max() < 350.0):
            raise AssertionError(f"int8 ({mid}) contract failed: rmse {rmse}, max {dmax}, "
                                 f"range {sr.min()}..{sr.max()}")

    # the comparison steps on the same granule: kernels='alt' on the prow
    # parameters (identical mosaic), up2_impl='vpu' parameters, and the plain
    # int8 step of predict --int8
    prow_mosaic = predict_granule(variables, lst, ndvi, stats, batch_size=N, device=dev,
                                  sr_step=step, step_params=qparams)
    alt_step = make_int8_sr_step(stats, kernels="alt", device=dev)
    t = time.perf_counter()
    vpu_step, vpu_params = make_quantized_step(variables, lst, ndvi, stats, use_pallas=True,
                                               up2_impl="vpu", device=dev)
    t_cal_vpu = time.perf_counter() - t
    t = time.perf_counter()
    q_step, q_params = make_quantized_step(variables, lst, ndvi, stats, use_pallas=False,
                                           device=dev)
    t_cal_q = time.perf_counter() - t
    per_batch["alt"] = dict(per_batch["prow"], conv_i8_in1_split=0, conv_i8_in1=1,
                            conv_i8_generic=0, conv_i8_outlay=1, conv_prow_dual_planes=0,
                            conv_prow_dual=2)
    per_batch["vpu"] = per_batch["prow"]
    per_batch["int8"] = {"conv_i8_generic": 18}          # every conv of the folded model
    mosaics = {}
    for name, int8_step, params in (("alt", alt_step, qparams), ("vpu", vpu_step, vpu_params),
                                    ("int8", q_step, q_params)):
        run(sr_step=int8_step, step_params=params)
        K.reset_launches()
        sr, wall[name] = run(sr_step=int8_step, step_params=params)
        launches[name] = {k.__name__: k.launches for k in K.KERNELS}
        want = {k.__name__: per_batch[name].get(k.__name__, 0) * n_batches for k in K.KERNELS}
        if launches[name] != want:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {want}")
        d = sr.astype(np.float64) - ref
        rmse, dmax = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
        log(f"granule: int8 ({name}) vs f32 RMSE {rmse:.4f} K, max {dmax:.4f} K, "
            f"range {sr.min():.2f}..{sr.max():.2f} K; launches {launches[name]}; mosaic "
            f"sha256 {digest(sr)}")
        if not (sr.shape == mosaic and np.isfinite(sr).all() and rmse < 0.3 and dmax < 1.0
                and sr.min() > 250.0 and sr.max() < 350.0):
            raise AssertionError(f"int8 ({name}) contract failed: rmse {rmse}, max {dmax}")
        mosaics[name] = sr
    if not np.array_equal(mosaics["alt"], prow_mosaic):
        raise AssertionError("the kernels='alt' mosaic differs from the default prow mosaic: max|d| "
                             f"{np.abs(mosaics['alt'] - prow_mosaic).max()}")
    log("granule: the kernels='alt' mosaic (E, F, L) is identical to the default prow mosaic")
    d = np.abs(mosaics["vpu"] - prow_mosaic)
    log(f"granule: up2_impl='vpu' vs 'mxu' mosaic: {int((d > 0).sum())} of {d.size} pixels "
        f"differ, max {d.max():.4f} K (one int8 quantum of the outlay's input is "
        f"{float(qparams['s']['ol']):.4f} normalised units, "
        f"{float(qparams['s']['ol']) * stats.std_lst:.4f} K)")
    if not d.max() < 0.5:
        raise AssertionError(f"the vpu mosaic is {d.max()} K off the mxu mosaic")
    del mosaics, prow_mosaic

    # device time of one serving batch for each step
    lst_d = torch.from_numpy(lst[:64 * 18, :64 * 18].reshape(18, 64, 18, 64)
                             .transpose(0, 2, 1, 3).reshape(N, 64, 64).copy()).to(dev)
    ndvi_d = torch.from_numpy(np.clip(ndvi, -1, 1)[:256 * 18, :256 * 18].reshape(18, 256, 18, 256)
                              .transpose(0, 2, 1, 3).reshape(N, 256, 256).copy()).to(dev)
    from sifsr_tpu_torch.inference import make_sr_step
    from sifsr_tpu_torch.models.fused import InferenceModelB2

    fmodel = InferenceModelB2.from_variables(variables).to(dev)
    bmodel = InferenceModelB2.from_variables(variables).to(dev, torch.bfloat16)
    ms_float = {}
    for pad in ("fused", "explicit", "explicit", "fused"):      # in turns, within one call
        f_step = make_sr_step(stats, torch.float32, dev, pad)
        b_step = make_sr_step(stats, torch.bfloat16, dev, pad)
        ms_float.setdefault(("f32", pad), []).append(
            time_ms(torch, lambda: f_step(fmodel, lst_d, ndvi_d), 5))
        ms_float.setdefault(("bf16", pad), []).append(
            time_ms(torch, lambda: b_step(bmodel, lst_d, ndvi_d), 5))
    # the defaults of make_sr_step: explicit pads in float32, fused in bf16
    ms_f32, ms_bf16 = min(ms_float[("f32", "explicit")]), min(ms_float[("bf16", "fused")])
    ms_i8 = {name: time_ms(torch, lambda f=f, p=p: f(p, lst_d, ndvi_d), 10)
             for name, f, p in (("prow", step, qparams), ("xla", xla_step, qparams),
                                ("alt", alt_step, qparams), ("vpu", vpu_step, vpu_params),
                                ("int8", q_step, q_params))}
    log(f"granule f32: {n_blocks / t_f32:.1f} patches/s wall ({t_f32:.3f} s), "
        f"step {ms_f32:.3f} ms/batch of {N} on device")
    log(f"granule bf16: {n_blocks / t_bf16:.1f} patches/s wall ({t_bf16:.3f} s), "
        f"step {ms_bf16:.3f} ms/batch of {N} on device")
    for (dtype, pad), v in ms_float.items():
        log(f"float step {dtype} pad_impl={pad}: {v[0]:.3f} / {v[1]:.3f} ms/batch of {N} "
            f"(two turns)")
    for name in ("prow", "xla", "alt", "vpu", "int8"):
        log(f"granule int8 ({name}): {n_blocks / wall[name]:.1f} patches/s wall "
            f"({wall[name]:.3f} s), step {ms_i8[name]:.3f} ms/batch of {N} on device")
    log(f"int8 calibration (make_quantized_step): prow/mxu {t_cal:.2f} s, prow/vpu "
        f"{t_cal_vpu:.2f} s, --int8 {t_cal_q:.2f} s")
    del fmodel, bmodel, lst_d, ndvi_d, vpu_params, q_params
    torch.cuda.empty_cache()

    # granule modes on the arrays (the default bf16 step and the int8 step)
    link = probe_link(dev)
    log(f"link probe: rtt {link['rtt_s'] * 1e6:.1f} us, h2d {link['h2d_bytes_per_s'] / 1e9:.2f} "
        f"GB/s, d2h {link['d2h_bytes_per_s'] / 1e9:.2f} GB/s (pinned), host tile copy "
        f"{link['host_bytes_per_s'] / 1e9:.2f} GB/s")
    # The wire rounds LST to 0.02 K and NDVI to 1e-4. On a granule that holds
    # multiples of those steps, as MODIS products do, the step sees the same
    # inputs on either wire, and all that differs is the mosaic rounded to
    # 0.02 K: within 0.01 K and a float32 ulp (3e-5 K at 300 K), for every
    # step. The synthetic fields are no such multiples: there an int8 or bf16
    # step answers the rounded inputs with flipped quanta, so its wire mosaic
    # is held to the step's own gate against the float32 mosaic, and each
    # mode identical to the host pipeline on the same wire.
    lst_w, ndvi_w = encode_wire(lst, np.clip(ndvi, -1, 1))
    exact = (lst_w.astype(np.float32) * np.float32(WIRE_LST_STEP),
             ndvi_w.astype(np.float32) * np.float32(WIRE_NDVI_STEP))
    del lst_w, ndvi_w
    for label, kw, (g_rmse, g_max) in (
            ("int8 prow", dict(sr_step=step, step_params=qparams), (0.3, 1.0)),
            ("bf16", {}, (0.1, 0.5)),
            # float32 answers the LST rounded by up to 0.01 K smoothly, with
            # gain on fine detail, and rounds its output by up to 0.01 K more
            ("f32", dict(compute_dtype=torch.float32), (0.01, 0.05))):
        dx = np.abs(run(exact, mode="host_pipeline", wire="int", **kw)[0]
                    - run(exact, mode="host_pipeline", **kw)[0])
        log(f"granule wire='int' vs float wire ({label}), granule on the wire's steps: max "
            f"{dx.max():.5f} K")
        if not dx.max() <= 0.0101:
            raise AssertionError(f"wire='int' ({label}) is {dx.max()} K off the float wire on a "
                                 "granule that encodes losslessly")
        del dx
        base = {None: run(mode="host_pipeline", **kw)[0],
                "int": run(mode="host_pipeline", wire="int", **kw)[0]}
        dw = np.abs(base["int"] - base[None])
        dr = base["int"].astype(np.float64) - ref
        rmse, dmax = float(np.sqrt((dr ** 2).mean())), float(np.abs(dr).max())
        log(f"granule wire='int' ({label}), synthetic granule: vs float wire max {dw.max():.4f} K, "
            f"RMSE {float(np.sqrt((dw.astype(np.float64) ** 2).mean())):.4f} K; vs the float32 "
            f"mosaic RMSE {rmse:.4f} K, max {dmax:.4f} K")
        if not (rmse < g_rmse and dmax < g_max):
            raise AssertionError(f"wire='int' ({label}) left the step's gate against the float32 "
                                 f"mosaic: rmse {rmse}, max {dmax}")
        del dw, dr
        for mode in ("host_pipeline", "device_tiling", "device_tiling_wire", "auto"):
            run(mode=mode, **kw)
            walls = [run(mode=mode, **kw) for _ in range(3)]
            dm = float(np.abs(walls[0][0] - base["int" if mode.endswith("wire") else None]).max())
            log(f"granule mode {mode} ({label}): wall {min(w for _, w in walls):.3f} s best of 3 "
                f"({' / '.join(f'{w:.3f}' for _, w in walls)}), max|d| vs the host pipeline on "
                f"the same wire {dm:.4f} K")
            if dm != 0.0:
                raise AssertionError(f"mode {mode} ({label}) is {dm} K off the host pipeline")
        del base, walls

    # 6. files: HDF4 and GeoTIFF inputs through cli.predict.main and cli.serve.main
    import json as _json
    import tempfile

    from sifsr_tpu_torch.data.ingest import compute_ndvi

    def struct_meta(size, res):
        return ("GROUP=GridStructure\n"
                f"\tXDim={size}\n\tYDim={size}\n"
                "\tUpperLeftPointMtrs=(0.000000,5559752.598333)\n"
                f"\tLowerRightMtrs=({size * res:.6f},{5559752.598333 - size * res:.6f})\n"
                "END_GROUP=GridStructure\n")

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        lst_dn = np.round(lst / 0.02).astype(np.uint16)
        red_dn = np.full(ndvi.shape, 900, np.int16)
        nir_dn = np.round(900.0 * (1.0 + ndvi) / (1.0 - ndvi)).astype(np.int16)
        files = {k: os.path.join(tmp, v) for k, v in dict(
            lst_hdf="MOD21A1D.A2017100.h18v04.061.hdf", refl_hdf="MOD09GQ.A2017100.h18v04.061.hdf",
            lst_tif="lst.tif", ndvi_tif="ndvi.tif").items()}
        write_hdf4_sds(files["lst_hdf"], {"LST_Day_1KM": lst_dn,
                                          "QC_Day": np.zeros(lst_dn.shape, np.uint8)},
                       struct_metadata=struct_meta(1200, 926.625433), deflate=True)
        write_hdf4_sds(files["refl_hdf"], {"sur_refl_b01_1": red_dn, "sur_refl_b02_1": nir_dn},
                       struct_metadata=struct_meta(4800, 231.656358), deflate=True)
        t_write = time.perf_counter() - t
        t = time.perf_counter()
        lst_f, _ = cli_predict._load_lst(files["lst_hdf"])
        ndvi_f, gt_ndvi = cli_predict._load_ndvi(files["refl_hdf"], None, False)
        t_decode = time.perf_counter() - t
        assert lst_f.shape == (1200, 1200) and ndvi_f.shape == (4800, 4800) and gt_ndvi is not None
        assert np.array_equal(ndvi_f, compute_ndvi(nir_dn.astype(np.float32) * np.float32(1e-4),
                                                   red_dn.astype(np.float32) * np.float32(1e-4)))
        write_geotiff(files["lst_tif"], lst_f, geotransform=(0.0, 926.625433, 0.0, 5559752.598333,
                                                             0.0, -926.625433))
        write_geotiff(files["ndvi_tif"], ndvi_f, geotransform=gt_ndvi)
        log(f"files: HDF pair written in {t_write:.2f} s "
            f"({os.path.getsize(files['lst_hdf']) / 1e6:.1f} + "
            f"{os.path.getsize(files['refl_hdf']) / 1e6:.1f} MB), decoded in {t_decode:.2f} s "
            f"({smi.splitlines()[0]})")
        hdf = ["--MOD21A1D_file_path", files["lst_hdf"], "--MOD09GQ_file_path", files["refl_hdf"]]
        tif = ["--MOD21A1D_file_path", files["lst_tif"], "--MOD09GQ_file_path", files["ndvi_tif"],
               "--ndvi_is_precomputed"]
        common = ["--model_dir", os.path.join(ROOT, "weights", "modelB_1009"), "--statistics",
                  os.path.join(ROOT, "data", "statistics_testset.json")]

        def command(name, inputs, *flags):
            out_dir = os.path.join(tmp, name)
            t0 = time.perf_counter()
            cli_predict.main([*inputs, "--save_path", out_dir, *common, *flags])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            g = read_geotiff(os.path.join(out_dir, "prediction.tiff"))
            if g.array.shape != mosaic or g.array.dtype != np.float32:
                raise AssertionError(f"predict {flags}: raster {g.array.shape} {g.array.dtype}")
            if not np.allclose(g.geotransform, gt_ndvi, rtol=0, atol=1e-6):
                raise AssertionError(f"predict {flags}: geotransform {g.geotransform} vs {gt_ndvi}")
            log(f"predict {' '.join(flags) or '(default bf16, fused pads)'} from "
                f"{'HDF' if inputs is hdf else 'GeoTIFF'}: {wall_s:.2f} s wall, "
                f"{g.array.min():.2f}..{g.array.max():.2f} K, raster sha256 {digest(g.array)} "
                f"({smi.splitlines()[0]})")
            return g.array

        def direct(**kw):
            return predict_granule(variables, lst_f, ndvi_f, stats, batch_size=N, device=dev, **kw)

        def same(name, got, want, tol=0.0):
            dm = float(np.abs(got - want).max())
            if not dm <= tol:
                raise AssertionError(f"predict {name}: the raster is {dm} K off predict_granule")

        ref_f = direct(compute_dtype=torch.float32)
        same("--f32", command("f32", tif, "--f32"), ref_f)
        same("default", command("bf16", hdf), direct())
        for name, inputs, flags, kw in (
                ("int8", hdf, ("--int8",), dict(use_pallas=False)),
                ("pallas", hdf, ("--pallas",), dict(use_pallas=True)),
                ("pallas_vpu", tif, ("--pallas", "--up2-impl", "vpu"),
                 dict(use_pallas=True, up2_impl="vpu"))):
            got = command(name, inputs, *flags)
            qs, qp = make_quantized_step(variables, lst_f, ndvi_f, stats, device=dev, **kw)
            want = direct(coverage=0.0, sr_step=qs, step_params=qp)
            same(" ".join(flags), got, want)
            d = got.astype(np.float64) - ref_f
            rmse, dmax = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
            log(f"predict {' '.join(flags)}: vs --f32 RMSE {rmse:.4f} K, max {dmax:.4f} K")
            if not (rmse < 0.3 and dmax < 1.0):
                raise AssertionError(f"predict {flags} left the int8 contract: {rmse}, {dmax}")
            if name == "pallas":
                pallas_raster = got
            del qs, qp, want
        for mode in ("host_pipeline", "device_tiling", "auto"):
            same(f"--pallas --mode {mode}", command(f"mode_{mode}", hdf, "--pallas", "--mode", mode),
                 pallas_raster)
        # the wire: NDVI from reflectance ratios is not a multiple of 1e-4, so
        # the int8 step sees rounded inputs and may flip quanta; both wire
        # commands must agree with each other and with predict_granule under
        # wire='int', and stay in the int8 contract. The float32 step answers
        # the rounding smoothly: within half the 0.02 K output step (the LST
        # DN encode losslessly) plus its response to NDVI rounded to 1e-4
        wired = command("mode_wire", hdf, "--pallas", "--mode", "device_tiling_wire")
        same("--pallas --wire int", command("wire", hdf, "--pallas", "--wire", "int"), wired)
        qs, qp = make_quantized_step(variables, lst_f, ndvi_f, stats, use_pallas=True, device=dev)
        same("--pallas --mode device_tiling_wire", wired,
             direct(coverage=0.0, sr_step=qs, step_params=qp, wire="int"))
        dw = np.abs(wired - pallas_raster)
        d = wired.astype(np.float64) - ref_f
        rmse, dmax = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
        log(f"predict --pallas --wire int: vs the float wire max {dw.max():.4f} K; vs --f32 RMSE "
            f"{rmse:.4f} K, max {dmax:.4f} K")
        if not (rmse < 0.3 and dmax < 1.0):
            raise AssertionError(f"predict --pallas --wire int left the int8 contract: {rmse}, {dmax}")
        same("--f32 --wire int", command("f32_wire", tif, "--f32", "--wire", "int"), ref_f, 0.012)
        del qs, qp, wired, dw, d
        # on rasters that hold multiples of the wire's steps the int8 step
        # sees the same inputs on either wire: only the output rounding
        # (0.01 K and a float32 ulp) is left
        lw, nw = encode_wire(lst_f, np.clip(ndvi_f, -1, 1))
        files["lst_x"], files["ndvi_x"] = os.path.join(tmp, "lst_x.tif"), os.path.join(tmp, "ndvi_x.tif")
        write_geotiff(files["lst_x"], lw.astype(np.float32) * np.float32(WIRE_LST_STEP),
                      geotransform=(0.0, 926.625433, 0.0, 5559752.598333, 0.0, -926.625433))
        write_geotiff(files["ndvi_x"], nw.astype(np.float32) * np.float32(WIRE_NDVI_STEP),
                      geotransform=gt_ndvi)
        del lw, nw
        tif_x = ["--MOD21A1D_file_path", files["lst_x"], "--MOD09GQ_file_path", files["ndvi_x"],
                 "--ndvi_is_precomputed"]
        same("--pallas --wire int on the wire's steps",
             command("wire_x", tif_x, "--pallas", "--wire", "int"),
             command("pallas_x", tif_x, "--pallas"), 0.0101)

        # the daemon: two good jobs, a missing file, broken JSON; one calibration
        watch = os.path.join(tmp, "jobs")
        os.makedirs(watch)
        jobs = {"a_hdf.json": {"lst": files["lst_hdf"], "ndvi": files["refl_hdf"]},
                "b_tif.json": {"lst": files["lst_tif"], "ndvi": files["ndvi_tif"],
                               "ndvi_is_precomputed": True,
                               "out": os.path.join(tmp, "served", "b.tiff")},
                "c_missing.json": {"lst": os.path.join(tmp, "missing.hdf"),
                                   "ndvi": files["refl_hdf"]}}
        for i, (name, job) in enumerate(jobs.items()):
            with open(os.path.join(watch, name), "w") as f:
                _json.dump(job, f)
            os.utime(os.path.join(watch, name), (1000.0 + i, 1000.0 + i))
        with open(os.path.join(watch, "d_broken.json"), "w") as f:
            f.write("{nope")
        builds = []
        real_build = cli_serve.make_quantized_step
        cli_serve.make_quantized_step = lambda *a, **kw: (builds.append(1), real_build(*a, **kw))[1]
        K.reset_launches()
        t0 = time.perf_counter()
        try:
            cli_serve.main(["--watch", watch, "--once", "--pallas", *common])
        finally:
            cli_serve.make_quantized_step = real_build
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        served = {k.__name__: k.launches for k in K.KERNELS}
        want = {k.__name__: per_batch["prow"].get(k.__name__, 0) * n_batches * 2 for k in K.KERNELS}
        outs = [os.path.join(watch, "done", "a_hdf.tiff"), jobs["b_tif.json"]["out"]]
        errs = sorted(f for f in os.listdir(os.path.join(watch, "failed")) if f.endswith(".err"))
        if served != want or len(builds) != 1 or errs != ["c_missing.err", "d_broken.err"]:
            raise AssertionError(f"serve: launches {served} (expected {want}), {len(builds)} "
                                 f"calibration(s), failed {errs}")
        for out in outs:
            same(f"serve {os.path.basename(out)}", read_geotiff(out).array, pallas_raster)
        log(f"serve --once --pallas: 2 rasters identical to predict --pallas, 2 failed jobs "
            f"isolated ({errs}), 1 calibration, {t_serve:.2f} s wall for the spool "
            f"({smi.splitlines()[0]})")
        del ref_f, pallas_raster, lst_f, ndvi_f

    # 7. one train step against the torch golden (its ds_loss runs kernel M)
    from sifsr_tpu_torch.config import load_params_json
    from sifsr_tpu_torch.data import make_synthetic_dataset, prepare_batch
    from sifsr_tpu_torch.train import create_train_state, make_train_step, train_loop
    from sifsr_tpu_torch.train.checkpoint import save_final
    import dataclasses

    fx = np.load(os.path.join(ROOT, "golden", "train_step_predef.npz"))
    tmodel = ModelB2()
    tstate = create_train_state(tmodel, 1e-3, variables=variables, device=dev)
    gstep = make_train_step(tmodel, "predef_filters", alpha=0.99, gamma=-0.5, mean_lst=295.0,
                            std_lst=10.0, with_metrics=False)
    gbatch = {k: f32(fx[k].transpose(0, 2, 3, 1)) for k in ("lst", "lst_up", "ndvi")}
    K.reset_launches()
    tstate, gm_ = gstep(tstate, gbatch)
    torch.cuda.synchronize()
    if (K.fused_psf_downscale.launches, K.fused_psf_downscale.backward_launches) != (1, 1):
        raise AssertionError("the golden step did not run fused_psf_downscale once each way")
    loss_d = {k: abs(float(gm_[k]) - float(fx[k])) for k in ("loss", "ds_loss", "percep_loss")}
    diffs, grads, bn = [], [], 0.0
    named = dict(tmodel.named_parameters())
    for k in fx.files:
        if not k.startswith("post__") or k.endswith("num_batches_tracked"):
            continue
        name = k[len("post__"):]
        d = np.abs(tmodel.state_dict()[name].cpu().numpy().astype(np.float64) - fx[k])
        if name in named:
            diffs.append(d.ravel())
            grads.append(named[name].grad.abs().cpu().numpy().ravel())
        else:
            bn = max(bn, float(d.max()))
    diffs, grads = np.concatenate(diffs), np.concatenate(grads)
    q999, dmax = float(np.quantile(diffs, 0.999)), float(diffs.max())
    well = float(diffs[grads >= 1e-6].max())
    log(f"golden train step: loss |d| {loss_d}, params q999 {q999:.3g} max {dmax:.3g} "
        f"(max where |grad| >= 1e-6: {well:.3g}, {int((grads >= 1e-6).sum())} of {grads.size}), "
        f"BN stats max {bn:.3g}")
    if not (max(loss_d.values()) < 5e-5 and q999 < 1e-4 and dmax < 1e-3 and well < 2e-5
            and bn < 5e-5):
        raise AssertionError("the golden train step is off the torch reference")
    del tmodel, tstate, gstep, gbatch, named

    # 8. training through train_loop, three recipes, paramsB.json's hyperparameters
    config = load_params_json(os.path.join(ROOT, "paramsB.json"))
    config = dataclasses.replace(config, hyper=dataclasses.replace(config.hyper, n_epochs=2))
    assert config.hyper.batch_size == TRAIN_BATCH and tuple(config.model.downchannels) == (16, 32, 64, 128)
    train_ds, val_ds = make_synthetic_dataset(64, seed=1), make_synthetic_dataset(32, seed=2)
    n_train = train_ds.n_batches(TRAIN_BATCH, drop_remainder=False) * config.hyper.n_epochs
    n_val = val_ds.n_batches(TRAIN_BATCH, drop_remainder=False) * config.hyper.n_epochs
    train_launches = {}
    for recipe in ("predef_filters", "gradftm", "scale_invariance"):
        K.reset_launches()
        t = time.perf_counter()
        state, metrics = train_loop(dataclasses.replace(config, recipe=recipe), train_ds, val_ds,
                                    log_fn=lambda line: log("  " + line), device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        train_launches[recipe] = {k.__name__: k.launches for k in K.KERNELS}
        train_launches[recipe]["fused_psf_downscale_backward"] = K.fused_psf_downscale.backward_launches
        sif = recipe != "scale_invariance"
        want = {k.__name__: 0 for k in K.KERNELS}
        want["fused_psf_downscale"] = (n_train + n_val) if sif else 0
        want["fused_psf_downscale_backward"] = n_train if sif else 0
        want["fused_norm_l4"] = 0 if sif else (n_train + n_val)   # the batch degradation
        if train_launches[recipe] != want:
            raise AssertionError(f"{recipe}: launches {train_launches[recipe]}, expected {want}")
        series = [v for k, v in metrics.items() if k != "best_epoch"]
        if not (all(len(v) == 2 for v in series) and np.isfinite(series).all()
                and state.step == n_train):
            raise AssertionError(f"{recipe}: bad metrics {metrics}")
        with tempfile.TemporaryDirectory() as tmp:
            save_final(tmp, config.save.model_name, state, metrics)
            back = load_variables(tmp, config.save.model_name)
        sd = state.model.state_dict()
        if list(back) != list(sd) or not all(torch.equal(back[k], sd[k].cpu()) for k in sd):
            raise AssertionError(f"{recipe}: save_final/load_variables did not give the weights back")
        log(f"train {recipe}: 2 epochs in {wall_s:.2f} s, train_loss {metrics['train_loss']}, "
            f"val_loss {metrics['val_loss']}; fused_psf_downscale "
            f"{want['fused_psf_downscale']} forward / {want['fused_psf_downscale_backward']} "
            f"backward launches, fused_norm_l4 {want['fused_norm_l4']}; weights saved and "
            f"read back equal")
        del state

    # device time of one train step at batch 32, with and without step metrics
    batch32 = prepare_batch(next(train_ds.batches(TRAIN_BATCH, seed=0)), device=dev)
    step_ms = {}
    for with_metrics in (True, False):
        smodel = ModelB2()
        sstate = create_train_state(smodel, config.hyper.learning_rate,
                                    generator=torch.Generator().manual_seed(0), device=dev)
        sstep = make_train_step(smodel, "predef_filters", config.hyper.alpha, config.hyper.gamma,
                                train_ds.stats.mean_lst, train_ds.stats.std_lst,
                                with_metrics=with_metrics)
        for _ in range(3):
            sstep(sstate, batch32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms[with_metrics] = time_ms(torch, lambda: sstep(sstate, batch32), 10)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"train step (predef_filters, float32, TF32 off, batch {TRAIN_BATCH}, "
            f"step metrics {'on' if with_metrics else 'off'}): {step_ms[with_metrics]:.3f} ms on "
            f"device, {TRAIN_BATCH / step_ms[with_metrics] * 1e3:.1f} samples/s, peak memory "
            f"{peak_gb:.3f} GiB")
    m_ms = entries["fused_psf_downscale"]["ms"] + entries["fused_psf_downscale_backward"]["ms"]
    log(f"fused_psf_downscale forward + backward: {m_ms:.4f} ms of the {step_ms[True]:.3f} ms "
        f"step ({100 * m_ms / step_ms[True]:.3f}%)")
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                sstep(sstate, batch32)
            torch.cuda.synchronize()
        log("profile of 3 train steps without step metrics (device time by kernel):")
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                      max_name_column_width=70))
        for ev in prof.key_averages():
            if "sandwich_kernel" in ev.key:
                log(f"profile: sandwich_kernel (fused_psf_downscale forward and backward): "
                    f"{ev.count} launches, device time {ev.device_time_total / ev.count:.1f} "
                    f"us each")
        # the step's other configurations, timed only (without step metrics)
        for label, kw, tf32, remat in (
                ("precision='default' with TF32 allowed", dict(precision="default"), True, False),
                ("bf16 autocast", dict(precision="default", dtype=torch.bfloat16), False, False),
                ("float32, TF32 off, remat", {}, False, True)):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            vmodel = ModelB2(**kw)
            vstate = create_train_state(vmodel, config.hyper.learning_rate,
                                        generator=torch.Generator().manual_seed(0), device=dev)
            vstep = make_train_step(vmodel, "predef_filters", config.hyper.alpha,
                                    config.hyper.gamma, train_ds.stats.mean_lst,
                                    train_ds.stats.std_lst, with_metrics=False, remat=remat)
            first = float(vstep(vstate, batch32)[1]["loss"])
            for _ in range(2):
                vstep(vstate, batch32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, lambda: vstep(vstate, batch32), 10)
            last = float(vstep(vstate, batch32)[1]["loss"])
            log(f"train step variant ({label}): {ms:.3f} ms, {TRAIN_BATCH / ms * 1e3:.1f} "
                f"samples/s, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
                f"loss {first:.5f} -> {last:.5f} over {vstate.step} steps on one batch")
            if not (np.isfinite(last) and last < first):
                raise AssertionError(f"train step variant ({label}) did not learn")
            del vmodel, vstate, vstep
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    del smodel, sstate, sstep, batch32

    src = "sifsr_tpu_torch/csrc/"
    meta = {
        "upsample_phases": (src + "resize_phases.cu", "sifsr_tpu/pallas/resize_phases.py:93"),
        "conv_i8_in1_split": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:732",
                              "entry sifsr_conv_i8_in1_split (int8 tensor cores, "
                              "conv_in1_mma_kernel), kernel shared with conv_i8_in1"),
        "conv_i8_exact": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:333",
                          "entry sifsr_conv_i8_exact (int8 tensor cores, the 16-channel "
                          "kernel of csrc/conv16.cuh), kernel shared with conv_i8_exact_dual "
                          "and, at 16 input channels, conv_prow and conv_prow_split_pool"),
        "conv_i8_exact_dual": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:395",
                               "entry sifsr_conv_i8_exact_dual: the kernel of conv_i8_exact "
                               "with two inputs"),
        "conv_i8_in1": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:605",
                        "the kernel of conv_i8_in1_split templated on the source"),
        "conv_i8_generic": (src + "conv_i8.cu", "sifsr_tpu/models/quantized_packed.py:66",
                            "entry sifsr_conv_i8_generic: at 16 -> 1 (the outlay, the only "
                            "call under prow) the kernel of conv_i8_outlay, the other shapes "
                            "on dp4a"),
        "conv_i8_outlay": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:464",
                           "entry sifsr_conv_i8_outlay (int8 tensor cores, "
                           "conv16_outlay_mma_kernel of csrc/conv16.cuh), kernel shared with "
                           "conv_i8_generic at 16 -> 1"),
        "conv_prow": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:335",
                      "entry sifsr_conv_prow (int8 tensor cores: at 16 channels the kernel "
                      "of conv_i8_exact, csrc/conv16.cuh; at 32 and 64 conv_prow_mma_kernel), "
                      "shared with conv_prow_split_pool"),
        "conv_prow_split_pool": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:488",
                                 "entry sifsr_conv_prow_split_pool: the kernels of conv_prow "
                                 "with the 2x2 pool"),
        "conv_prow_up2": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:971",
                          "entry sifsr_conv_prow_up2 (int8 tensor cores, main loop "
                          "csrc/conv_mma.cuh), shared with conv_prow_up2_pack"),
        "conv_prow_dual_planes": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:549",
                                  "entry sifsr_conv_prow_dual (int8 tensor cores, main loop "
                                  "csrc/conv_mma.cuh), shared with conv_prow_dual"),
        "conv_prow_up2_pack": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:908",
                               "entry sifsr_conv_prow_up2, shared with conv_prow_up2"),
        "conv_prow_up2[vpu]": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:582",
                               "entry sifsr_conv_prow_up2_vpu: the kernel of conv_prow_up2 "
                               "with the float32 x2 chain of up2_impl='vpu'"),
        "conv_prow_up2_pack[vpu]": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:864",
                                    "entry sifsr_conv_prow_up2_vpu, shared with "
                                    "conv_prow_up2[vpu]"),
        "conv_prow_dual": (src + "conv_px.cu", "sifsr_tpu/pallas/conv_px.py:398",
                           "entry sifsr_conv_prow_dual, shared with conv_prow_dual_planes: "
                           "in NHWC the skip is one tensor"),
        "fused_psf_downscale": (src + "fused_ops.cu", "sifsr_tpu/pallas/fused_ops.py:47",
                                "entry sifsr_sandwich, shared with its backward"),
        "fused_psf_downscale_backward": (src + "fused_ops.cu", "sifsr_tpu/pallas/fused_ops.py:76",
                                         "entry sifsr_sandwich with the transposed matrix"),
        "fused_norm_l4": (src + "fused_ops.cu", "sifsr_tpu/pallas/fused_ops.py:129"),
    }
    # each kernel's main path: the int8 (prow) granule of phase 5 for the
    # serving kernels (the kernels='alt' granule for E, F and L, the
    # up2_impl='vpu' granule for the float32 x2 chain), the predef_filters
    # loop of phase 8 for the ds-loss kernel, the scale_invariance loop (its
    # batch degradation) for the norm-L4 kernel
    def counter(name):
        return name.split("[")[0]

    main_launches = dict(launches["prow"])
    for name in ("conv_i8_in1", "conv_i8_outlay", "conv_prow_dual"):
        main_launches[name] = launches["alt"][name]
    for name in ("conv_prow_up2[vpu]", "conv_prow_up2_pack[vpu]"):
        main_launches[name] = launches["vpu"][counter(name)]
    for name in ("fused_psf_downscale", "fused_psf_downscale_backward"):
        main_launches[name] = train_launches["predef_filters"][name]
    main_launches["fused_norm_l4"] = train_launches["scale_invariance"]["fused_norm_l4"]
    by_path = dict(launches, **{"train_" + r: c for r, c in train_launches.items()})
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": main_launches[name], "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
         "library_ms": e["library_ms"], "calls_per_batch": e["calls"],
         **({"per_call": e["per_call"]} if "per_call" in e else {}),
         # the [vpu] entries share their wrapper's counter with the integer
         # chain: only the vpu granule's count is theirs
         "launches_by_path": {path: c.get(counter(name), 0) for path, c in by_path.items()
                              if "[vpu]" not in name or path == "vpu"},
         **({"shares": meta[name][2]} if len(meta[name]) > 2 else {})}
        for name, e in entries.items()]}
    missing = [k["name"] for k in kernels_line["kernels"] if not k["launches"] > 0]
    if missing:
        raise AssertionError(f"kernels never launched on their main path: {missing}")
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def demangle(name: str) -> str:
    """A C++ symbol as c++filt prints it, where the toolkit's host has
    c++filt; else as it is."""
    import shutil

    if shutil.which("c++filt") is None:
        return name
    import re

    out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=30).stdout
    # the name and template arguments, without namespace, return type and parameters
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", out)
    return m.group(1) if m else name


def synthetic_granule(rng):
    """A 1200² LST field (290-320 K, no 0 K fill) and a 4800² NDVI field
    (0.1-0.8), made from a seed: smooth sinusoids of random direction and
    phase, a few cycles per ten blocks, clipped to the ranges, plus a little
    pixel noise. The field is statistically the same everywhere, as the int8
    step's calibration (the granule's first 8 valid blocks) assumes."""
    def field(n, freqs):
        yy, xx = np.meshgrid(np.linspace(0, 1, n, dtype=np.float32),
                             np.linspace(0, 1, n, dtype=np.float32), indexing="ij")
        out = np.zeros((n, n), np.float32)
        for f in freqs:
            t, p = rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
            out += np.sin(2 * np.pi * f * (np.cos(t) * yy + np.sin(t) * xx) + p).astype(np.float32)
        return out / len(freqs)

    lst = 305.0 + 24.0 * field(1200, (7.3, 13.1, 21.7)) + rng.normal(0, 0.3, (1200, 1200))
    ndvi = 0.45 + 0.6 * field(4800, (9.1, 17.3, 33.9)) + rng.normal(0, 0.02, (4800, 4800))
    return (np.clip(lst, 290.0, 320.0).astype(np.float32),
            np.clip(ndvi, 0.1, 0.8).astype(np.float32))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler table of three train steps")
    main(parser.parse_args().profile)
