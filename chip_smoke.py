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
   (1,2048,2048), and the bands past 64 coefficients: factor 32 and 64 at
   (4,256,256), 128 at (2,256,256), 64 at (2,1024,1024)) through the
   wrapper: value and gradient within 1e-5 of float64, one launch each way;
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
   the time of the step under TF32, under bf16 autocast and with remat;
9. eval (``eval_phase``): 40 synthetic ASTER pairs in the harness's format
   (``write_aster_pairs``, cut from phase 5's granule) and seeded full-width
   VGG16/LPIPS weights (``write_lpips_weights``) in a temporary directory;
   ``cli.model_perf.main`` with ``--serving f32``, ``--serving prow
   --device-metrics --save-pairs``, ``--serving bf16``, ``--serving pallas``
   and ``--sr-type bicubic``: each performances.csv in the reference's
   layout with finite LPIPS; the prow and pallas runs launch exactly phase
   5's prow and xla counts once per pair, the others none; the device
   metric block within rtol 2e-4 / atol 2e-4 of the host path on the prow
   run's crops (and both timed over the 40 pairs); LPIPS on the card within
   1e-5 relative of the CPU on three crops; attenuation_spectrum within
   1e-5 dB of attenuation_spectrum_np; each serving path's sr_fn on every
   pair, as each run called it (ms a pair): f32 within rtol 1e-4 / atol
   5e-5 of the CPU on two pairs, on outputs normalised by the statistics
   (phase 4's bound), bf16 within RMSE 0.1 K / max 0.5 K of f32, prow and
   pallas within 0.3 K / 1 K; every pair scored; wall seconds per run;
10. baselines (``baselines_phase``), over phase 9's pairs and results:
   ``cli.model_perf.main`` with ``--sr-type`` bicubic, TsHARP, ATPRK, AATPRK
   and DMS, each ``--save-pairs``: each performances.csv in the reference's
   layout with every value finite, every pair scored and pickled, no
   kernel launched; DMS's bagged trees grown and applied on the card, and
   on two pairs refitted on the card (equal to the run's output) and on the
   CPU: equal leaf counts and thresholds, the LST within 1e-4 K; ms a pair
   on both. ``cli.compare_methods.main(["spectra", ...])`` over the four
   baselines and phase 9's prow run on the card, then with ``--device
   cpu``: the scores within 1e-6 relative. ``cli.process_modis`` and
   ``cli.data_preparation`` on a 384² / 1536² HDF4 pair cut from the
   granule (``process_modis``'s matplotlib histogram, drawn last, stops on
   its import where matplotlib is absent, as in the JAX package; that one
   ``ImportError`` is caught and said): 36 pairs, the first LST patch the
   granule's, the statistics JSON equal to ``compute_statistics`` on the
   written Train patches;
11. training, the rest (``train_rest_phase``), at full width and
   paramsB.json's batch of 32: the native raster loader built by g++ from
   ``csrc/sifsr_native.cpp`` (asserted where g++ and zlib.h are present;
   a failed build prints the compiler's first error line) against the
   Python reader on 160 seeded GeoTIFF pairs (``write_training_manifest``:
   raw and deflate strips; equal arrays, both decode rates);
   ``cli.train.main`` with ``--streaming --pad-impl fused`` and without
   ``--streaming``, 2 epochs of predef_filters each (kernel M 10 forward /
   8 backward launches, the weights saved; the streaming batches equal to
   ModisDataset's by digest; epoch and command wall times); one step with
   explicit and fused pads in float32 and bf16 (first losses within rtol
   1e-4 / atol 1e-5; ms a step); ``ModelB2(bilinear=False)``'s step on the
   card against the same step on the CPU; two gloo ranks sharing the card
   (``dp_worker``, 16 of a global batch of 32 each) identical to each
   other and against the single-process step on all 32 (metrics within
   1e-6 relative, 1e-5 for PSNR/SSIM; ``step_diffs_ok``), and
   ``predict_granule(mesh=...)`` with the prow step on phase 5's granule,
   its mosaic identical to phase 5's;
12. the packed comparison steps (``packed_phase``) on phase 5's granule at
   batch 324 through ``predict_granule``: ``make_packed_sr_step`` in
   float32 (within rtol 1e-4 / atol 5e-3 K of phase 5's float32 mosaic) and
   bf16 (RMSE 0.1 K / max 0.5 K), no hand-written kernel launched;
   ``make_int8_packed_sr_step`` calibrated by ``calibrate_packed_scales`` on
   the granule's first 8 fully valid blocks (RMSE 0.3 K / max 1 K, inside
   250-350 K; conv_i8_generic exactly 18 a batch, no other kernel; within 3
   int8 quanta of the outlay's input of phase 5's --int8 mosaic, whose convs
   it runs), and the same step given the calibrated packed tree as it is
   (JAX's form, un-packed on every call): the same launches, its mosaic
   identical to the un-packed tree's; ``upsample_bilinear_x2_nhwc_hp`` at
   (324,128,128,16) card vs CPU within 1e-6; the step ms of the four beside
   the prow and --int8 steps, two turns, with conv TFLOP/s from
   ``utils.flops.modelb2_conv_flops``;
13. bf16 convergence (``convergence_phase``): ``python -m
   sifsr_tpu_torch.tools.bf16_convergence`` at its defaults (predef_filters,
   24 epochs on 32 / 8 synthetic pairs, float32 against bf16) in a process
   of its own: every loss finite, each curve's last validation loss below
   its first; the summary (final validation losses, relative differences)
   on a line of its own, not gated.

The second-to-last line is the kernels JSON, the last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one, or without the repository beside it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 324                      # predict's batch: one 1200² granule = 18x18 blocks
TRAIN_BATCH = 32             # paramsB.json
N_EVAL_PAIRS = 40            # synthetic ASTER pairs of the eval phase
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
    from sifsr_tpu_torch.inference import _batches, predict_granule
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
    t_main = time.perf_counter()

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
    # factor 2), and the bands past 64 coefficients, whose step 2 reads them
    # from memory (factor 32 and 64 at 256²: 68 and 132; factor 128 at 256²:
    # 194, a 2x2 output; factor 64 at 1024²: 132), value and gradient
    # against float64, one launch each way
    for n_, size_, factor_ in ((4, 256, 16), (2, 1024, 8), (1, 2048, 2), (4, 256, 32),
                               (4, 256, 64), (2, 256, 128), (2, 1024, 64)):
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
            f"{len(band_m.tile_in)} / {len(band_mt.tile_in)} tiles; forward "
            f"{time_ms(torch, lambda: fused_ops.fused_psf_downscale(xr.detach(), mean_lst, std_lst, factor=factor_), 5):.4f} ms")
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
    n_batches = len(_batches(n_blocks, N, None))        # a granule: 4 batches of 81
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
    prow_digest = digest(prow_mosaic)
    int8_mosaic = mosaics["int8"]          # phase 12 holds the packed int8 mosaic to it
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
    del fmodel, bmodel, lst_d, ndvi_d, vpu_params
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

    # 9. eval: cli.model_perf over synthetic ASTER pairs (eval_phase); 10.
    # the classical baselines, compare_methods and the data tooling over
    # the same pairs and results (baselines_phase)
    t_eval = time.perf_counter()
    with tempfile.TemporaryDirectory() as eval_dir:
        eval_launches, lpips_files = eval_phase(torch, dev, (lst, ndvi), per_batch,
                                                smi.splitlines()[0], eval_dir)
        t_base = time.perf_counter()
        baselines_phase(torch, dev, (lst, ndvi), smi.splitlines()[0], eval_dir, lpips_files)
    # 11. the rest of training: the native loader, streaming training with
    # fused pads, the ConvTranspose decoder, data parallelism (train_rest_phase)
    t_rest = time.perf_counter()
    with tempfile.TemporaryDirectory() as rest_dir:
        rest_launches = train_rest_phase(torch, dev, smi.splitlines()[0], rest_dir, (lst, ndvi),
                                         prow_digest, per_batch["prow"], profile)
    # 12. the packed comparison steps, float and int8, on phase 5's granule
    # (packed_phase)
    t_packed = time.perf_counter()
    packed_launches = packed_phase(torch, dev, smi.splitlines()[0], (lst, ndvi), ref, variables,
                                   stats, {"prow": (step, qparams), "--int8": (q_step, q_params)},
                                   int8_mosaic)
    # 13. the bf16-vs-float32 convergence tool (convergence_phase)
    t_conv = time.perf_counter()
    with tempfile.TemporaryDirectory() as conv_dir:
        convergence_phase(smi.splitlines()[0], conv_dir)
    log(f"wall s: phases 1-8 {t_eval - t_main:.1f}, phase 9 (eval) {t_base - t_eval:.1f}, "
        f"phase 10 (baselines) {t_rest - t_base:.1f}, phase 11 (training, the rest) "
        f"{t_packed - t_rest:.1f}, phase 12 (packed steps) {t_conv - t_packed:.1f}, "
        f"phase 13 (bf16 convergence) {time.perf_counter() - t_conv:.1f}")

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
    by_path = dict(launches, packed_int8=packed_launches,
                   **{"train_" + r: c for r, c in train_launches.items()},
                   **{"eval_" + r: eval_launches[r] for r in ("prow", "pallas")},
                   **{"phase11_" + r: c for r, c in rest_launches.items()})
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


SUMMARY_ROWS = ["mean", "std", "10%", "Q1", "mediane", "Q3", "90%"]


def scored_model_perf_run(torch, argv: list, out: str, key, calls: dict, n_pairs: int,
                          label: str):
    """One ``cli.model_perf.main(argv)`` run writing ``out``, with each
    ``sr_fn`` it builds recording its calls (inputs, output, host seconds)
    under ``calls[key(args, kwargs)]`` of its ``make_sr_fn`` call, so that
    the gates hold the very calls whose launches were counted. Raises
    unless ``performances.csv`` is in the reference's layout with every one
    of ``n_pairs`` pairs scored by one ``sr_fn`` call. Returns the frame,
    the run's wall seconds and its launches by kernel."""
    import pandas as pd

    import sifsr_tpu_torch.kernels as K
    from sifsr_tpu_torch.cli import model_perf
    from sifsr_tpu_torch.eval.harness import METRIC_COLUMNS

    make_sr_fn = model_perf.make_sr_fn

    def recording_sr_fn(*args, **kwargs):
        fn, log_ = make_sr_fn(*args, **kwargs), []
        calls[key(args, kwargs)] = log_

        def sr_fn(lst, ndvi):
            t0 = time.perf_counter()
            y = fn(lst, ndvi)
            log_.append((lst.copy(), ndvi.copy(), y, time.perf_counter() - t0))
            return y
        return sr_fn

    calls_before = set(calls)
    torch.cuda.synchronize()
    K.reset_launches()
    t = time.perf_counter()
    model_perf.make_sr_fn = recording_sr_fn
    try:
        model_perf.main(argv + ["--out", out])
    finally:
        model_perf.make_sr_fn = make_sr_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in K.KERNELS}
    df = pd.read_csv(os.path.join(out, "performances.csv"), index_col=0)
    new = [k for k in calls if k not in calls_before]
    n_calls = len(calls[new[0]]) if len(new) == 1 else -1
    if (list(df.columns) != list(METRIC_COLUMNS) or list(df.index[-7:]) != SUMMARY_ROWS
            or len(df) - len(SUMMARY_ROWS) != n_pairs or n_calls != n_pairs):
        raise AssertionError(f"{label}: performances.csv off its layout or a pair not scored "
                             f"({n_calls} sr_fn calls for {n_pairs} pairs):\n{df}")
    return df, wall, launches


def eval_phase(torch, dev, granule, per_batch: dict, card: str, tmp: str,
               n_pairs: int = N_EVAL_PAIRS) -> tuple:
    """Phase 9: ``cli.model_perf.main`` over ``n_pairs`` synthetic ASTER pairs
    (``write_aster_pairs``, cut from ``granule``) in the harness's format,
    ModelB_2 at full width through the f32, prow (with --device-metrics),
    bf16 and pallas serving paths, one pair a call, and the bicubic floor,
    LPIPS through a seeded full-width VGG16 (``write_lpips_weights``) on
    ``dev``, all under ``tmp``, where phase 10 finds them. Raises on any
    gate; returns each run's launch counts and the two weight files.
    ``card``: the nvidia-smi line printed beside the times; ``per_batch``:
    phase 5's launches a batch of the prow and xla steps, each pair's
    expected counts."""
    import sifsr_tpu_torch.kernels as K
    from sifsr_tpu_torch.cli import model_perf
    from sifsr_tpu_torch.eval.device_metrics import COLUMNS, device_metric_rows
    from sifsr_tpu_torch.data.statistics import Statistics
    from sifsr_tpu_torch.eval.harness import compute_pair_metrics
    from sifsr_tpu_torch.eval.lpips import LPIPS
    from sifsr_tpu_torch.eval.spectra import attenuation_spectrum, attenuation_spectrum_np

    eval_launches = {}
    t = time.perf_counter()
    write_aster_pairs(tmp, n_pairs, seed=1, granule=granule)
    vgg_path, lp_path = write_lpips_weights(tmp)
    log(f"eval: {n_pairs} ASTER pairs and the VGG16/LPIPS weights written in "
        f"{time.perf_counter() - t:.1f} s")
    base = ["--dataset", tmp, "--statistics", os.path.join(ROOT, "data",
                                                          "statistics_testset.json"),
            "--model-dir", os.path.join(ROOT, "weights", "modelB_1009"),
            "--vgg16-weights", vgg_path, "--lpips-weights", lp_path, "--device", str(dev)]
    runs = {"f32": ["--serving", "f32"], "prow": ["--serving", "prow", "--device-metrics",
                                                 "--save-pairs"],
            "bf16": ["--serving", "bf16"], "pallas": ["--serving", "pallas"],
            "bicubic": ["--sr-type", "bicubic"]}
    # each run's sr_fn, as main builds it, records its calls, keyed by
    # the serving path (the model) or the sr_type
    calls = {}

    def run_key(args, kwargs):
        return kwargs.get("serving", "f32") if args[0] == "modelB" else args[0]

    frames, eval_wall = {}, {}
    for name, flags in runs.items():
        df, eval_wall[name], eval_launches[name] = scored_model_perf_run(
            torch, base + flags, os.path.join(tmp, "results", name), run_key, calls, n_pairs,
            f"eval {name}")
        pairs_df = df.drop(index=SUMMARY_ROWS)
        if not np.isfinite(pairs_df["LPIPS"].to_numpy(float)).all():
            raise AssertionError(f"eval {name}: LPIPS not finite:\n{df}")
        frames[name] = df
        mean = df.loc["mean"]
        log(f"eval {name}: {eval_wall[name]:.1f} s wall for {len(pairs_df)} scored pairs of "
            f"{n_pairs}; mean PSNR {mean['PSNR']:.3f} SSIM {mean['SSIM']:.4f} RMSE "
            f"{mean['RMSE']:.4f} K GSSIM {mean['GSSIM']:.4f} LPIPS {mean['LPIPS']:.5f} "
            f"RMSE_grad {mean['RMSE_grad']:.4f}")
    # the int8 paths launch exactly phase 5's kernels, once per pair (the
    # harness SRs every pair of the manifest before it crops)
    for name, mid in (("prow", "prow"), ("pallas", "xla")):
        want = {k.__name__: per_batch[mid].get(k.__name__, 0) * n_pairs for k in K.KERNELS}
        if eval_launches[name] != want:
            raise AssertionError(f"eval {name}: launches {eval_launches[name]}, expected {want}")
    for name in ("f32", "bf16", "bicubic"):
        if any(eval_launches[name].values()):
            raise AssertionError(f"eval {name}: launched {eval_launches[name]}")
    log(f"eval launches: prow {eval_launches['prow']}, pallas {eval_launches['pallas']}")

    # the device metric block against the port's host path, on the crops
    # the prow run pickled
    crops = []
    for idx in frames["prow"].drop(index=SUMMARY_ROWS).index:
        with open(os.path.join(tmp, "results", "prow", f"{idx}_dict_pred.pkl"), "rb") as f:
            c = pickle.load(f)
        crops.append((idx, c["LST_SR"], c["LST_ASTER"]))
    worst = 0.0
    for idx, sr_c, as_c in crops:
        host = compute_pair_metrics(sr_c, as_c)
        for col in COLUMNS:
            got_v, want_v = frames["prow"].loc[idx, col], host[col]
            worst = max(worst, abs(got_v - want_v) / (2e-4 + 2e-4 * abs(want_v)))
            if not np.isclose(got_v, want_v, rtol=2e-4, atol=2e-4):
                raise AssertionError(f"eval: device block {col} of pair {idx}: {got_v} vs host "
                                     f"{want_v}")
    pair_list = [(c[1], c[2]) for c in crops]
    ms_dev = time_ms(torch, lambda: device_metric_rows(pair_list, dev), 5)
    t = time.perf_counter()
    for _, sr_c, as_c in crops:
        compute_pair_metrics(sr_c, as_c)
    ms_host = (time.perf_counter() - t) * 1e3
    log(f"eval metric block: device {ms_dev:.2f} ms for {len(crops)} pairs (one call, crops "
        f"{min(c[1].shape[0] for c in crops)}-{max(c[1].shape[0] for c in crops)} px) vs host "
        f"numpy {ms_host:.2f} ms; every column within rtol 2e-4 / atol 2e-4 of the host path "
        f"(worst at {worst:.1%} of its bound)")

    # LPIPS on the card against the CPU, and its time a call
    lp_card = LPIPS(vgg_path, lp_path, device=dev)
    lp_host = LPIPS(vgg_path, lp_path, device="cpu")
    for _, sr_c, as_c in crops[:3]:
        lo, hi = min(sr_c.min(), as_c.min()), max(sr_c.max(), as_c.max())
        a_, b_ = (sr_c - lo) / (hi - lo), (as_c - lo) / (hi - lo)
        got_v, want_v = lp_card(a_, b_), lp_host(a_, b_)
        if not abs(got_v - want_v) <= 1e-5 * abs(want_v):
            raise AssertionError(f"eval: LPIPS on the card {got_v} vs CPU {want_v}")
    ms_lpips = time_ms(torch, lambda: lp_card(a_, b_), 10)
    log(f"eval LPIPS: card within 1e-5 relative of the CPU on 3 crops (last {got_v:.6f} vs "
        f"{want_v:.6f}); {ms_lpips:.3f} ms a call at {a_.shape}")

    # the spectra through cuFFT against the float64 numpy form
    sp_err = 0.0
    for _, _, as_c in crops[:3]:
        got_sp = attenuation_spectrum(torch.from_numpy(as_c.astype(np.float32)).to(dev))
        want_sp = attenuation_spectrum_np(as_c.astype(np.float32).astype(np.float64))
        sp_err = max(sp_err, float(np.abs(got_sp.cpu().numpy() - want_sp).max()))
    log(f"eval attenuation_spectrum: max |d| {sp_err:.3g} dB vs attenuation_spectrum_np")
    if not sp_err <= 1e-5:
        raise AssertionError(f"eval: attenuation_spectrum off by {sp_err} dB")

    # the model on the card: the sr_fn outputs of the runs above, every
    # pair of each serving path against f32's, and f32's against the same
    # sr_fn on the CPU. All runs took the pairs in the manifest's order.
    for name in ("bf16", "prow", "pallas"):
        if not all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(calls[name], calls["f32"])):
            raise AssertionError(f"eval: the {name} run took other inputs than f32's")
    sr_out = {name: [c[2] for c in calls[name]] for name in ("f32", "bf16", "prow", "pallas")}
    # mean host ms a call over pairs 2..n (the first call builds)
    sr_ms = {name: 1e3 * float(np.mean([c[3] for c in calls[name][1:]]))
             for name in sr_out}
    stats_json = os.path.join(ROOT, "data", "statistics_testset.json")
    stats = Statistics.from_json(stats_json)
    f32_cpu = model_perf.make_sr_fn("modelB", os.path.join(ROOT, "weights", "modelB_1009"),
                                    stats_json, device="cpu")
    # phase 4's bound on the normalised outputs, (y - mean_lst) / std_lst:
    # in Kelvin atol 5e-5 * std_lst
    for lst, ndvi, y, _ in calls["f32"][:2]:
        np.testing.assert_allclose((y - stats.mean_lst) / stats.std_lst,
                                   (f32_cpu(lst, ndvi) - stats.mean_lst) / stats.std_lst,
                                   rtol=1e-4, atol=5e-5)
    for name, (b_rmse, b_max) in (("bf16", (0.1, 0.5)), ("prow", (0.3, 1.0)),
                                  ("pallas", (0.3, 1.0))):
        d = np.stack(sr_out[name]).astype(np.float64) - np.stack(sr_out["f32"])
        rmses = np.sqrt((d ** 2).mean(axis=(1, 2)))
        log(f"eval sr_fn {name} vs f32 over {n_pairs} pairs: worst RMSE "
            f"{rmses.max():.4f} K, max {np.abs(d).max():.4f} K")
        if not (rmses.max() < b_rmse and np.abs(d).max() < b_max):
            raise AssertionError(f"eval: {name} sr_fn off f32: RMSE {rmses.max()}, max "
                                 f"{np.abs(d).max()}")
    log(card + ": eval sr_fn ms a pair (host clock, batch 1, inside the model_perf run, "
        f"mean over pairs 2-{n_pairs}, input upload and output download included): " + ", ".join(f"{k} {v:.3f}" for k, v in sr_ms.items())
        + "; wall s a model_perf run: " + ", ".join(f"{k} {v:.1f}"
                                                     for k, v in eval_wall.items())
        + f"; metric block over {len(crops)} pairs: device {ms_dev:.2f} ms, host numpy "
        f"{ms_host:.2f} ms; LPIPS {ms_lpips:.3f} ms a call")
    del sr_out, calls, lp_card, lp_host, f32_cpu
    torch.cuda.empty_cache()
    return eval_launches, (vgg_path, lp_path)


def baselines_phase(torch, dev, granule, card: str, tmp: str, lpips_files: tuple,
                    n_pairs: int = N_EVAL_PAIRS) -> None:
    """Phase 10 over phase 9's pairs and results under ``tmp``:
    ``cli.model_perf.main`` with ``--sr-type`` bicubic, TsHARP, ATPRK, AATPRK
    and DMS (its trees on ``dev``), each ``--save-pairs``; DMS on the card
    against the CPU on two pairs; ``cli.compare_methods.main(["spectra",
    ...])`` on ``dev`` against ``--device cpu``; ``cli.process_modis`` and
    ``cli.data_preparation`` on an HDF4 pair cut from ``granule``. Raises on
    any gate."""
    import shutil

    import pandas as pd

    from sifsr_tpu_torch.baselines.dms import DecisionTreeSharpener
    from sifsr_tpu_torch.cli import compare_methods, data_preparation, process_modis
    from sifsr_tpu_torch.data.statistics import Statistics, compute_statistics
    from sifsr_tpu_torch.geo.hdf4 import write_hdf4_sds
    from sifsr_tpu_torch.geo.tiff import read_geotiff

    stats_json = os.path.join(ROOT, "data", "statistics_testset.json")
    base = ["--dataset", tmp, "--statistics", stats_json, "--vgg16-weights", lpips_files[0],
            "--lpips-weights", lpips_files[1], "--device", str(dev), "--save-pairs"]
    calls, wall = {}, {}
    sr_types = ("bicubic", "TsHARP", "ATPRK", "AATPRK", "DMS")
    for sr_type in sr_types:
        out = os.path.join(tmp, "results", sr_type)
        df, wall[sr_type], launches = scored_model_perf_run(
            torch, base + ["--sr-type", sr_type], out, lambda args, kwargs: args[0], calls,
            n_pairs, f"baselines {sr_type}")
        launched = {k: v for k, v in launches.items() if v}
        pairs_df = df.drop(index=SUMMARY_ROWS)
        pkls = [f for f in os.listdir(out) if f.endswith("_dict_pred.pkl")]
        if len(pkls) != n_pairs or launched or not np.isfinite(pairs_df.to_numpy(float)).all():
            raise AssertionError(f"baselines {sr_type}: {len(pkls)} pickles, a value not "
                                 f"finite or a kernel launched ({launched}):\n{df}")
        mean = df.loc["mean"]
        log(f"baselines {sr_type}: {wall[sr_type]:.1f} s wall for {len(pairs_df)} scored pairs; "
            f"mean PSNR {mean['PSNR']:.3f} SSIM {mean['SSIM']:.4f} RMSE {mean['RMSE']:.4f} K "
            f"GSSIM {mean['GSSIM']:.4f} LPIPS {mean['LPIPS']:.5f}")

    # DMS on the card against the CPU on two pairs: the same trees, the
    # sharpened LST within 1e-4 K; the card's is the run's own output
    worst, cpu_s = 0.0, []
    for lst, ndvi, y, _ in calls["DMS"][:2]:
        fitted = {}
        for d in (dev, "cpu"):
            t = time.perf_counter()
            sh = DecisionTreeSharpener(factor=4, device=d).train(ndvi, lst)
            fitted[str(d)] = (sh, sh.residual_correction(sh.apply(ndvi), lst))
            if d == "cpu":
                cpu_s.append(time.perf_counter() - t)
        (card_sh, card_y), (cpu_sh, cpu_y) = fitted[str(dev)], fitted["cpu"]
        leaves = card_sh.reg.n_leaves()
        if leaves != cpu_sh.reg.n_leaves() or not all(
                np.array_equal(card_sh.reg.thresholds(i), cpu_sh.reg.thresholds(i))
                for i in range(card_sh.reg.n_estimators)):
            raise AssertionError(f"baselines DMS: trees on the card {leaves} vs the CPU "
                                 f"{cpu_sh.reg.n_leaves()}")
        if not np.array_equal(card_y, y):
            raise AssertionError("baselines DMS: a second card fit differs from the run's")
        worst = max(worst, float(np.abs(card_y - cpu_y).max()))
    if not worst <= 1e-4:
        raise AssertionError(f"baselines DMS: card vs CPU {worst} K")
    dms_ms = 1e3 * float(np.mean([c[3] for c in calls["DMS"][1:]]))
    log(f"baselines DMS: card vs CPU on 2 pairs: equal leaf counts ({leaves} on the last) and "
        f"thresholds, max |d| {worst:.3g} K (bound 1e-4)")
    sr_ms = {k: 1e3 * float(np.mean([c[3] for c in v[1:]])) for k, v in calls.items()}

    # compare_methods spectra on the card, then on the CPU, over the same pickles
    models = ["TsHARP", "ATPRK", "AATPRK", "DMS", "prow"]
    results = os.path.join(tmp, "results")
    scores, spectra_s = {}, {}
    for d in (str(dev), "cpu"):
        t = time.perf_counter()
        compare_methods.main(["spectra", "--results-dir", results, "--models", *models,
                              "--device", d])
        spectra_s[d] = time.perf_counter() - t
        scores[d] = {m: pd.read_csv(os.path.join(results, m, "performances.csv"), index_col=0)
                     .loc[:, ["PFR", "AFR", "FRR", "FRO", "FRU"]].drop(index=SUMMARY_ROWS)
                     .to_numpy(float) for m in models}
    worst = 0.0
    for m in models:
        got, want = scores[str(dev)][m], scores["cpu"][m]
        if got.shape != (n_pairs, 5) or not np.isfinite(got).all():
            raise AssertionError(f"compare_methods spectra {m}: scores {got.shape}, not all finite")
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        worst = max(worst, float(np.where(got == want, 0.0, rel).max()))
    if not worst <= 1e-6:
        raise AssertionError(f"compare_methods spectra: card vs CPU {worst} relative")
    log(f"compare_methods spectra over {len(models)} models x {n_pairs} pairs: card "
        f"{spectra_s[str(dev)]:.2f} s, CPU {spectra_s['cpu']:.2f} s wall; scores within "
        f"{worst:.3g} relative of the CPU (bound 1e-6)")

    # the data tooling: an HDF4 pair cut from the granule, written as the
    # files phase writes its pair, through process_modis and data_preparation
    lst_g, ndvi_g = granule
    work = os.path.join(tmp, "modis")
    lst_dir, nir_dir = os.path.join(work, "MOD21A1D.061"), os.path.join(work, "MOD09GQ.061")
    os.makedirs(lst_dir)
    os.makedirs(nir_dir)
    size = 384

    def struct_meta(n, res):
        return ("GROUP=GridStructure\n"
                f"\tXDim={n}\n\tYDim={n}\n"
                "\tUpperLeftPointMtrs=(0.000000,5559752.598333)\n"
                f"\tLowerRightMtrs=({n * res:.6f},{5559752.598333 - n * res:.6f})\n"
                "END_GROUP=GridStructure\n")

    t = time.perf_counter()
    nd = ndvi_g[:4 * size, :4 * size]
    write_hdf4_sds(os.path.join(lst_dir, "MOD21A1D.A2017100.h18v04.061.hdf"),
                   {"LST_Day_1KM": np.round(lst_g[:size, :size] / 0.02).astype(np.uint16),
                    "QC_Day": np.zeros((size, size), np.uint8)},
                   struct_metadata=struct_meta(size, 926.625433), deflate=True)
    write_hdf4_sds(os.path.join(nir_dir, "MOD09GQ.A2017100.h18v04.061.hdf"),
                   {"sur_refl_b01_1": np.full(nd.shape, 900, np.int16),
                    "sur_refl_b02_1": np.round(900.0 * (1.0 + nd) / (1.0 - nd)).astype(np.int16)},
                   struct_metadata=struct_meta(4 * size, 231.656358), deflate=True)
    pairs_csv = os.path.join(work, "pairs_day.csv")
    try:
        process_modis.main(["--lst-dir", lst_dir, "--nirred-dir", nir_dir,
                            "--out-lst", os.path.join(work, "LST"),
                            "--out-ndvi", os.path.join(work, "NDVI"), "--pairs-out", pairs_csv])
        histogram = "and its georeference histogram"
    except ImportError as e:
        # the histogram, drawn after the patches and the CSV are written,
        # needs matplotlib, as in the JAX package; the card machine has none
        if e.name != "matplotlib":
            raise
        histogram = "(no georeference histogram: matplotlib is not installed)"
    stats_out = os.path.join(work, "statistics.json")
    data_preparation.main(["--pairs", pairs_csv, "--out", os.path.join(work, "ModisDatasetB.csv"),
                           "--statistics-out", stats_out])
    tooling_s = time.perf_counter() - t
    pairs = pd.read_csv(pairs_csv, index_col=0)
    manifest = pd.read_csv(os.path.join(work, "ModisDatasetB.csv"), index_col=0)
    train = manifest[manifest["split"] == "Train"]
    want = compute_statistics((read_geotiff(p).array for p in train["LST"]),
                              (read_geotiff(p).array for p in train["NDVI"]))
    got = Statistics.from_json(stats_out)
    if len(pairs) != (size // 64) ** 2 or got != want:
        raise AssertionError(f"process_modis/data_preparation: {len(pairs)} pairs, statistics "
                             f"{got} vs {want}")
    patch = read_geotiff(pairs["LST"].iloc[0]).array
    if not np.array_equal(patch, (np.round(lst_g[:64, :64] / 0.02).astype(np.uint16)
                                  .astype(np.float32) * np.float32(0.02))):
        raise AssertionError("process_modis: the first LST patch is not the granule's")
    shutil.rmtree(work)
    log(f"data tooling: process_modis and data_preparation over a {size}² / {4 * size}² HDF4 "
        f"pair in {tooling_s:.1f} s: {len(pairs)} pairs {histogram}, {len(train)} train; the "
        f"statistics JSON equal to compute_statistics on the written patches")
    log(card + ": baselines wall s a model_perf run over " + f"{n_pairs} pairs: "
        + ", ".join(f"{k} {v:.1f}" for k, v in wall.items())
        + "; sr_fn ms a pair (mean over pairs 2-" + f"{n_pairs}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in sr_ms.items())
        + f"; DMS ms a pair on the card {dms_ms:.3f}, on the host's CPU "
        f"{1e3 * float(np.mean(cpu_s)):.3f} (2 pairs, fit, apply and residual correction)")
    log("phase 10 ran: model_perf --sr-type " + ", ".join(sr_types)
        + "; compare_methods spectra (card and CPU); process_modis; data_preparation")


def packed_phase(torch, dev, card: str, granule, ref, variables, stats, phase5_steps: dict,
                 int8_mosaic) -> dict:
    """Phase 12: the space-to-depth packed comparison steps through
    ``predict_granule`` on phase 5's granule at batch 324, each mosaic held
    against phase 5's float32 mosaic ``ref``: the float32 packed step within
    rtol 1e-4 / atol 5e-3 K (the JAX package's packed-vs-standard bound),
    the bf16 one within RMSE 0.1 K / max 0.5 K, the int8 one (calibrated by
    ``calibrate_packed_scales`` on the granule's first 8 fully valid blocks,
    as ``make_quantized_step`` picks them) within RMSE 0.3 K / max 1 K inside
    250-350 K, launching ``conv_i8_generic`` exactly 18 times a batch and no
    other kernel. The int8 one runs --int8's 18 convs at its shapes on the
    same weights, so it is also held to phase 5's --int8 mosaic
    ``int8_mosaic``: at most 3 int8 quanta of the outlay's input (its
    calibrated ``in_scale`` x std_lst, in K) apart anywhere. The int8 step
    then takes the calibrated packed tree as it is, as JAX's step does, and
    un-packs it on every call: the same launches, and a mosaic identical to
    the un-packed tree's. Then ``upsample_bilinear_x2_nhwc_hp`` at (324,128,128,16)
    on the card against the CPU within 1e-6, and the step ms of the four
    beside phase 5's prow and --int8 steps (``phase5_steps``: name -> (step,
    params)), CUDA events on
    device-resident inputs, in two turns, with the conv TFLOP/s of each
    (``modelb2_conv_flops`` a patch). Returns the int8 step's launches."""
    from sifsr_tpu_torch import kernels as K
    from sifsr_tpu_torch.inference import _batches, predict_granule, tile_granule
    from sifsr_tpu_torch.models.packed import make_packed_sr_step, packed_step_params
    from sifsr_tpu_torch.models.quantized_packed import (
        calibrate_packed_scales,
        make_int8_packed_sr_step,
        quantize_packed_params,
        unpacked_int8_params,
    )
    from sifsr_tpu_torch.ops.resize import upsample_bilinear_x2_nhwc_hp
    from sifsr_tpu_torch.utils.flops import modelb2_conv_flops

    lst, ndvi = granule
    lst_b, ndvi_b, _ = tile_granule(lst, np.clip(ndvi, -1, 1))
    n_batches = len(_batches(lst_b.shape[0], N, None))

    def run(step, params):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict_granule(variables, lst, ndvi, stats, batch_size=N, device=dev,
                              sr_step=step, step_params=params)
        return out, time.perf_counter() - t

    def diffs(sr):
        assert sr.shape == ref.shape and np.isfinite(sr).all(), sr.shape
        d = sr.astype(np.float64) - ref
        return float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())

    sel = np.nonzero((lst_b != 0).all(axis=(1, 2)))[0][:8]
    t = time.perf_counter()
    i8_tree = calibrate_packed_scales(variables, quantize_packed_params(variables, dev),
                                      lst_b[sel], ndvi_b[sel], stats, device=dev)
    t_cal = time.perf_counter() - t
    i8_params = unpacked_int8_params(i8_tree)
    int8_step = make_int8_packed_sr_step(stats, dev)
    steps = {
        "packed f32": (make_packed_sr_step(stats, torch.float32, dev),
                       packed_step_params(variables, torch.float32, dev)),
        "packed bf16": (make_packed_sr_step(stats, device=dev),
                        packed_step_params(variables, torch.bfloat16, dev)),
        "packed int8": (int8_step, i8_params),
        # JAX's form: the calibrated packed tree as it is, un-packed by the
        # step on every call
        "packed int8, packed tree": (int8_step, i8_tree),
    }
    wall, launches, int8_sr = {}, {}, None
    for name, (step, params) in steps.items():
        run(step, params)
        K.reset_launches()
        sr, wall[name] = run(step, params)
        launches[name] = {k.__name__: k.launches for k in K.KERNELS}
        rmse, dmax = diffs(sr)
        log(f"granule {name} vs phase 5's f32 mosaic: RMSE {rmse:.4f} K, max {dmax:.4f} K, range "
            f"{sr.min():.2f}..{sr.max():.2f} K, {lst_b.shape[0] / wall[name]:.1f} patches/s wall "
            f"({wall[name]:.3f} s); launches {launches[name]}; mosaic sha256 {digest(sr)}")
        if not name.startswith("packed int8") and any(launches[name].values()):
            raise AssertionError(f"{name} launched a hand-written kernel: {launches[name]}")
        if name == "packed f32":
            np.testing.assert_allclose(sr, ref, rtol=1e-4, atol=5e-3)
        elif name == "packed bf16":
            if not (rmse < 0.1 and dmax < 0.5):
                raise AssertionError(f"{name}: rmse {rmse}, max {dmax}")
        elif name == "packed int8":
            want = {k.__name__: 18 * n_batches if k is K.conv_i8_generic else 0
                    for k in K.KERNELS}
            if launches[name] != want:
                raise AssertionError(f"{name}: launches {launches[name]}, expected {want}")
            if not (rmse < 0.3 and dmax < 1.0 and sr.min() > 250.0 and sr.max() < 350.0):
                raise AssertionError(f"{name}: rmse {rmse}, max {dmax}, range "
                                     f"{sr.min()}..{sr.max()}")
            quantum = float(i8_params["outlay"]["conv"]["in_scale"]) * stats.std_lst
            d = np.abs(sr.astype(np.float64) - int8_mosaic)
            log(f"granule {name} vs phase 5's --int8 mosaic: {int((d > 0).sum())} of {d.size} "
                f"pixels differ, RMSE {float(np.sqrt((d ** 2).mean())):.5f} K, max "
                f"{d.max():.4f} K; one int8 quantum of the outlay's input is {quantum:.4f} K")
            if not d.max() <= 3 * quantum:
                raise AssertionError(f"{name} is {d.max()} K off the --int8 mosaic, more than "
                                     f"3 quanta of {quantum} K")
            int8_sr = sr
        else:
            # the packed tree's route: the un-packed route's launches and mosaic
            if launches[name] != launches["packed int8"]:
                raise AssertionError(f"{name}: launches {launches[name]}, expected "
                                     f"{launches['packed int8']}")
            if not np.array_equal(sr, int8_sr):
                raise AssertionError(f"{name}: the mosaic differs from the un-packed tree's")
            log(f"granule {name}: mosaic identical to the un-packed tree's")
        del sr
    del int8_sr
    log(f"packed int8 calibration (quantize_packed_params + calibrate_packed_scales on "
        f"{sel.size} blocks): {t_cal:.2f} s; unpacked_int8_params "
        f"{time_ms(torch, lambda: unpacked_int8_params(i8_tree), 5):.3f} ms a call")

    x = torch.from_numpy(np.random.default_rng(12).standard_normal((N, 128, 128, 16),
                                                                   dtype=np.float32))
    got = upsample_bilinear_x2_nhwc_hp(x.to(dev)).cpu().numpy()
    want = upsample_bilinear_x2_nhwc_hp(x).numpy()
    log(f"upsample_bilinear_x2_nhwc_hp {tuple(x.shape)}: card vs CPU max|d| "
        f"{np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    del x, got, want

    # step ms on one device-resident batch, beside phase 5's prow and --int8
    # steps, in two turns
    steps.update(phase5_steps)
    lst_d = torch.from_numpy(lst_b[:N].copy()).to(dev)
    ndvi_d = torch.from_numpy(ndvi_b[:N].copy()).to(dev)
    ms: dict = {}
    order = list(steps)
    for turn in (order, order[::-1]):
        for name in turn:
            step, params = steps[name]
            ms.setdefault(name, []).append(
                time_ms(torch, lambda: step(params, lst_d, ndvi_d), 5))
    flops = modelb2_conv_flops()
    log(f"modelb2_conv_flops: {flops:.0f} a patch (256²), {flops * N / 1e9:.3f} GFLOP a batch "
        f"of {N}")
    for name in order:
        best = min(ms[name])
        log(f"step {name}: {' / '.join(f'{v:.3f}' for v in ms[name])} ms/batch of {N} (two "
            f"turns; {card}), {flops * N / (best * 1e-3) / 1e12:.2f} conv TFLOP/s")
    return launches["packed int8"]


def convergence_phase(card: str, tmp: str, timeout: float = 600.0) -> dict:
    """Phase 13: ``python -m sifsr_tpu_torch.tools.bf16_convergence`` as a
    user runs it, at its defaults (predef_filters, 24 epochs on 32 / 8
    synthetic pairs, batch 8, ModelB2 in float32 with TF32 off and in bf16,
    on the card), in a process of its own, writing into ``tmp``. Gates:
    every loss finite, and each curve's last validation loss below its
    first; the relative difference of bf16 from float32 is recorded, not
    gated. Logs each run's first and last epochs and the summary on a line
    of its own; returns the summary."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sifsr_tpu_torch.tools.bf16_convergence",
                           "--out", tmp], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise RuntimeError(f"bf16_convergence failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    for run in ("f32", "bf16"):
        epochs = [line for line in lines if line.startswith(f"[{run}] epoch")]
        log(f"  {epochs[0]}\n  {epochs[-1]}")
    with open(os.path.join(tmp, "convergence.json")) as f:
        result = json.load(f)
    if not os.path.getsize(os.path.join(tmp, "convergence.png")) > 0:
        raise AssertionError("bf16_convergence wrote no curve PNG")
    log(f"bf16_convergence at its defaults: {wall:.1f} s wall, the process's start included "
        f"({card}); summary:")
    log(json.dumps(result["summary"]))
    for run, curve in result["curves"].items():
        losses = np.asarray(curve["train_loss"] + curve["val_loss"])
        if not np.isfinite(losses).all():
            raise AssertionError(f"bf16_convergence {run}: a loss is not finite: {curve}")
        if not curve["val_loss"][-1] < curve["val_loss"][0]:
            raise AssertionError(f"bf16_convergence {run}: the validation loss went "
                                 f"{curve['val_loss'][0]} -> {curve['val_loss'][-1]}")
    return result["summary"]


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


# the MODIS 250 m sinusoidal tile h18v04 (lon 0-15 E, lat 40-50 N): the
# geotransform of the 4800² canvas the ASTER pairs' patches are cut from
MODIS_TILE_GT = (0.0, 231.65635826395825, 0.0, 5559752.598333, 0.0, -231.65635826395825)


def write_aster_pairs(directory: str, n_pairs: int, seed: int = 0, granule=None) -> list:
    """Write ``n_pairs`` synthetic ASTER test pairs under ``directory`` in the
    evaluation harness's format (``eval.harness.run_evaluation``):
    ``dataset.csv`` and, in ``data/``, ``{i}_data_dict.pkl`` and
    ``{i}_aster_250m.tif``. Returns the pairs' (row, col) centres.

    Each pair is cut from the seeded synthetic granule (``granule``, else
    ``synthetic_granule(default_rng(seed))``) on the h18v04 canvas: a 64²
    LST in K (plus 0.25 K of seeded noise, which breaks the plateaus where
    the granule is clipped: a flat SR has no gradient variance, and GSSIM
    is then NaN) and the 256² NDVI under it, at a seeded 4-aligned centre. The
    pickle holds them with ``center_ndvi``, ``to CRS`` (``EPSG:<n>``, the
    UTM zone of the centre), ``transform affine SR`` (an ``affine.Affine``
    pickled by stand-in classes registered under that module name only
    while pickling, so that it loads as the real ones do: its six
    arguments land in NEWOBJ's ``newargs``) and ``aster_angle``. The ASTER
    GeoTIFF is a 250 m UTM raster in DN (K x 10, uint16) of a "truth" field
    (the bicubic x4 of the LST, minus 12 K per unit NDVI above the patch
    mean, plus a seeded smooth perturbation and 0.3 K of noise), valid over
    a 40 km square rotated by ``aster_angle`` (3-9 degrees) and offset up to
    2 km from the patch's centre, inside the patch's 59 km footprint as a
    real scene lies in its MODIS patch, 0 (nodata) outside it; the common
    area is then about 150-170 px a side."""
    import pickle
    import types

    import torch

    from sifsr_tpu_torch.geo import projection as prj
    from sifsr_tpu_torch.geo.tiff import write_geotiff
    from sifsr_tpu_torch.geo.warp import bilinear_sample
    from sifsr_tpu_torch.ops.resize import upsample_bicubic

    rng = np.random.default_rng(seed)
    lst_g, ndvi_g = granule if granule is not None else synthetic_granule(
        np.random.default_rng(seed))
    data = os.path.join(directory, "data")
    os.makedirs(data, exist_ok=True)
    gt = MODIS_TILE_GT

    class Affine(tuple):
        __slots__ = ()
        __module__ = "affine"
        __qualname__ = "Affine"

        def __new__(cls, *args):
            return tuple.__new__(cls, args)

        def __getnewargs__(self):
            return tuple(self)

    stand_in = types.ModuleType("affine")
    stand_in.Affine = Affine
    centres, rows = [], []
    half = 192                                     # truth window: 384² around the patch
    for i in range(n_pairs):
        cy, cx = (int(v) * 4 for v in rng.integers(600 // 4, 4200 // 4, 2))
        centres.append((cy, cx))
        lst = (lst_g[(cy - 128) // 4:(cy + 128) // 4, (cx - 128) // 4:(cx + 128) // 4]
               + rng.normal(0.0, 0.25, (64, 64)))
        ndvi = ndvi_g[cy - 128:cy + 128, cx - 128:cx + 128]
        lon, lat = prj.sinusoidal_to_lonlat(np.array([gt[0] + cx * gt[1]]),
                                            np.array([gt[3] + cy * gt[5]]))
        epsg = 32600 + int((float(lon[0]) + 180.0) // 6.0) + 1
        angle = float(rng.uniform(3.0, 9.0))

        # the truth on the 384² NDVI-resolution window around the patch
        y0, x0 = cy - half, cx - half
        lst_w = lst_g[y0 // 4:(cy + half) // 4, x0 // 4:(cx + half) // 4]
        up = upsample_bicubic(torch.from_numpy(np.ascontiguousarray(lst_w, np.float32))[None],
                              4)[0].numpy().astype(np.float64)
        nd = ndvi_g[y0:cy + half, x0:cx + half].astype(np.float64)
        yy, xx = np.mgrid[0:2 * half, 0:2 * half] / (2.0 * half)
        bump = sum(rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (rng.uniform(1, 4) * yy
                   + rng.uniform(1, 4) * xx) + rng.uniform(0, 2 * np.pi)) for _ in range(3))
        truth = (up - 12.0 * (nd - ndvi.mean()) + bump
                 + rng.normal(0.0, 0.3, up.shape))

        # the ASTER raster: 250 m UTM pixels over 96 km around the centre
        ue, un = prj.sinusoidal_to_utm(np.array([gt[0] + cx * gt[1]]),
                                       np.array([gt[3] + cy * gt[5]]), epsg)
        n_px, res = 384, 250.0
        a_gt = (float(ue[0]) - n_px * res / 2, res, 0.0, float(un[0]) + n_px * res / 2, 0.0, -res)
        jj, ii = np.meshgrid(np.arange(n_px), np.arange(n_px))
        ux = a_gt[0] + (jj + 0.5) * res
        uy = a_gt[3] - (ii + 0.5) * res
        sx, sy = prj.utm_to_sinusoidal(ux, uy, epsg)
        rr = (sy - gt[3]) / gt[5] - 0.5 - y0
        cc = (sx - gt[0]) / gt[1] - 0.5 - x0
        k = bilinear_sample(truth, rr, cc, fill=0.0)
        # valid over a 40 km square rotated by the scene angle, offset from the patch
        off = rng.uniform(-2000.0, 2000.0, 2)
        t = np.deg2rad(angle)
        du, dv = ux - float(ue[0]) - off[0], uy - float(un[0]) - off[1]
        ru, rv = np.cos(t) * du + np.sin(t) * dv, -np.sin(t) * du + np.cos(t) * dv
        inside = (np.abs(ru) < 20_000.0) & (np.abs(rv) < 20_000.0) & (k > 0)
        dn = np.where(inside, np.round(k * 10.0), 0.0).astype(np.uint16)
        aster_name = f"{i}_aster_250m.tif"
        write_geotiff(os.path.join(data, aster_name), dn, geotransform=a_gt, epsg=epsg,
                      nodata=0)

        record = {
            "LST": lst.astype(np.float32), "NDVI": ndvi.astype(np.float32),
            "center_ndvi": (cy, cx), "to CRS": f"EPSG:{epsg}",
            "transform affine SR": Affine(gt[1], gt[2], gt[0], gt[4], gt[5], gt[3]),
            "aster_angle": angle,
        }
        before = sys.modules.get("affine")
        sys.modules["affine"] = stand_in
        try:
            with open(os.path.join(data, f"{i}_data_dict.pkl"), "wb") as f:
                pickle.dump(record, f, protocol=4)
        finally:
            if before is None:
                del sys.modules["affine"]
            else:
                sys.modules["affine"] = before
        rows.append(f"{i},./data/{aster_name},./data/{i}_data_dict.pkl")
    with open(os.path.join(directory, "dataset.csv"), "w") as f:
        f.write(",Aster 250m UTM,MODIS patch\n" + "\n".join(rows) + "\n")
    return centres


def write_lpips_weights(directory: str, seed: int = 7) -> tuple[str, str]:
    """Seeded full-width VGG16 ``features`` weights in torchvision's layout
    (13 convs, 14.7 M parameters, He-scaled so the activations keep their
    range) and non-negative LPIPS layer weights, written as
    ``vgg16_features.pt`` and ``lpips_weights.pt`` under ``directory``;
    returns the two paths."""
    import torch

    rng = np.random.default_rng(seed)
    sd, c_in = {}, 3
    for idx, c in ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
                   (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512)):
        std = np.sqrt(2.0 / (9 * c_in))
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(0, std, (c, c_in, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.01, c).astype(np.float32))
        c_in = c
    vgg, lp = os.path.join(directory, "vgg16_features.pt"), os.path.join(directory,
                                                                         "lpips_weights.pt")
    torch.save(sd, vgg)
    torch.save([torch.from_numpy(rng.random((1, c, 1, 1)).astype(np.float32))
                for c in (64, 128, 256, 512, 512)], lp)
    return vgg, lp


DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD = 0.99, -0.5, 295.0, 10.0   # paramsB.json; the data's


def train_rest_phase(torch, dev, card: str, tmp: str, granule, prow_digest: str,
                     prow_per_batch: dict, profile: bool = False) -> dict:
    """Phase 11, the rest of training, at full width and paramsB.json's
    batch of 32, under ``tmp``: the native loader against the Python reader
    on a manifest of 160 GeoTIFF pairs (``write_training_manifest``: 128
    Train, 32 Val, raw and deflate strips); ``cli.train.main --streaming
    --pad-impl fused`` and the same without --streaming for 2 epochs of
    predef_filters (kernel M; the streaming batches equal the materialised
    ones, by digest); one step with fused and explicit pads in float32 and
    bf16 (first losses within rtol 1e-4 / atol 1e-5, tests/test_pad_impl.py's
    bounds); ``ModelB2(bilinear=False)``'s step on the card against the same
    step on the CPU; two gloo ranks on this card (``dp_worker``), 16 of a
    global batch of 32 each, against the single-process step on all 32, and
    ``predict_granule(mesh=...)`` on phase 5's granule with the prow step,
    whose mosaic must have ``prow_digest`` and each rank launch
    ``prow_per_batch`` (its one batch). Each part logs the phase's seconds
    so far; ``profile`` adds a torch.profiler table of the fused float32
    step. Raises on any failure (after every part ran); returns the
    launches of each path run here."""
    import contextlib
    import csv
    import io
    import re

    from sifsr_tpu_torch import kernels as K
    from sifsr_tpu_torch.cli import train as cli_train
    from sifsr_tpu_torch.cli.predict import load_variables
    from sifsr_tpu_torch.data import ModisDataset, Statistics, StreamingModisDataset
    from sifsr_tpu_torch.data import native_loader
    from sifsr_tpu_torch.models.unet import ModelB2
    from sifsr_tpu_torch.train import create_train_state, make_train_step

    def counts():
        c = {k.__name__: k.launches for k in K.KERNELS}
        c["fused_psf_downscale_backward"] = K.fused_psf_downscale.backward_launches
        return c

    launches, failures = {}, []
    t_phase = time.perf_counter()

    def at() -> str:
        return f"[phase 11 at {time.perf_counter() - t_phase:.1f} s]"

    def check(ok: bool, what: str) -> None:
        """A failed gate is logged and raised at the end of the phase, so
        that one run reports every part."""
        if not ok:
            log(f"FAILED: {what}")
            failures.append(what)

    # the native loader, built from csrc/sifsr_native.cpp by g++
    tools = native_loader.toolchain_available()
    try:
        native = native_loader.native_available()
    except RuntimeError as exc:
        lines = str(exc).splitlines()
        log("native loader: the build failed: "
            + next((ln for ln in lines if "error" in ln), lines[0]))
        raise
    if tools and not native:
        raise AssertionError("g++ and zlib.h are present but the native loader is not")
    log("native loader: " + (f"native decoder, {native_loader.library_path().name}" if native
                             else "Python reader (no g++ or no zlib.h on this machine)"))
    csv_path, stats_path = write_training_manifest(os.path.join(tmp, "patches"), 128, 32,
                                                   seed=11)
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    lst_paths, ndvi_paths = [r["LST"] for r in rows], [r["NDVI"] for r in rows]
    t = time.perf_counter()
    nat = (native_loader.load_batch(lst_paths, 64, 64),
           native_loader.load_batch(ndvi_paths, 256, 256))
    t_nat = time.perf_counter() - t
    t = time.perf_counter()
    py = (np.stack([native_loader._read_band1(p) for p in lst_paths]),
          np.stack([native_loader._read_band1(p) for p in ndvi_paths]))
    t_py = time.perf_counter() - t
    if not (np.array_equal(nat[0], py[0]) and np.array_equal(nat[1], py[1])):
        raise AssertionError("native and Python decodes differ")
    log(f"decode of {len(rows)} pairs (64² LST + 256² NDVI, raw and deflate strips): "
        f"{'native' if native else 'Python (fallback)'} {len(rows) / t_nat:.1f} pairs/s, "
        f"Python {len(rows) / t_py:.1f} pairs/s; arrays equal {at()}")

    # streaming and materialised training through cli.train.main
    with open(os.path.join(ROOT, "paramsB.json")) as f:
        params = json.load(f)
    params["hyperparameters"]["n_epochs"] = 2
    stats = Statistics.from_json(stats_path)
    time_of_day = params["dataset_parameter"]["time"]
    for seed in (1, 2):    # train_loop's batch seeds of epochs 1 and 2 (config.seed 0)
        got = [digest(b["lst"]) + digest(b["ndvi"]) for b in StreamingModisDataset(
            csv_path, stats, time=time_of_day).batches(32, seed=seed, drop_remainder=False)]
        want = [digest(b["lst"]) + digest(b["ndvi"]) for b in ModisDataset(
            csv_path, stats, time=time_of_day).batches(32, seed=seed, drop_remainder=False)]
        if got != want or len(got) != 4:
            raise AssertionError(f"streaming batches differ from the materialised ones "
                                 f"(seed {seed})")
    log("streaming batches equal to ModisDataset's for the loop's seeds (4 a epoch, digests)")
    wall = {}
    for label, extra in (("streaming", ["--streaming"]), ("materialised", [])):
        params["save_parameters"]["save_path"] = os.path.join(tmp, f"model_{label}")
        params_path = os.path.join(tmp, f"params_{label}.json")
        with open(params_path, "w") as f:
            json.dump(params, f)
        argv = ["--params", params_path, "--recipe", "predef_filters", "--statistics",
                stats_path, "--csv", csv_path, *extra, "--pad-impl", "fused", "--device", "cuda"]
        K.reset_launches()
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            try:
                cli_train.main(argv)
            except ImportError as exc:   # plot_loss, after save_final, as in JAX
                if "matplotlib" not in str(exc):
                    raise
                print("(plot_loss: matplotlib is not installed)")
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t
        launches["train_" + label] = counts()
        epochs = [float(s) for s in re.findall(r"epoch \d+/2 .*\((\d+\.\d+)s\)", out.getvalue())]
        want = {k.__name__: 0 for k in K.KERNELS}
        want.update(fused_psf_downscale=10, fused_psf_downscale_backward=8)  # 4+1 / 4 an epoch
        if launches["train_" + label] != want or len(epochs) != 2:
            raise AssertionError(f"cli.train {label}: launches {launches['train_' + label]}, "
                                 f"expected {want}; log:\n{out.getvalue()}")
        if not os.path.exists(os.path.join(params["save_parameters"]["save_path"],
                                           "modelB_state_dict.pt")):
            raise AssertionError(f"cli.train {label} saved no weights")
        log(f"cli.train --pad-impl fused {' '.join(extra)}: 2 epochs of predef_filters, "
            f"{wall[label]:.2f} s wall for the command, epochs {epochs} s; fused_psf_downscale "
            f"10 forward / 8 backward launches ({card}) {at()}")
        for line in out.getvalue().splitlines():
            if line.startswith("epoch"):
                log("  " + line)

    # fused against explicit pads, one step each way, float32 and bf16
    batch32 = {k: torch.from_numpy(v).to(dev) for k, v in dp_batch(32, 256, 7).items()}
    for dtype in (torch.float32, torch.bfloat16):
        first, ms = {}, {}
        for impl in ("explicit", "fused"):
            model = ModelB2(pad_impl=impl, dtype=dtype,
                            precision="highest" if dtype == torch.float32 else "default")
            state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(0),
                                       device=dev)
            step = make_train_step(model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD,
                                   with_metrics=False)
            first[impl] = float(step(state, batch32)[1]["loss"])
            ms[impl] = time_ms(torch, lambda: step(state, batch32), 10)
            if profile and impl == "fused" and dtype == torch.float32:
                from torch.profiler import ProfilerActivity, profile as torch_profile

                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        step(state, batch32)
                    torch.cuda.synchronize()
                log("profile of 3 float32 train steps with fused pads (device time by op):")
                log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                              max_name_column_width=70))
            del model, state, step
        d = abs(first["fused"] - first["explicit"])
        log(f"train step {str(dtype).split('.')[1]} (batch 32, predef_filters): explicit pads "
            f"{ms['explicit']:.3f} ms, fused {ms['fused']:.3f} ms; first loss {first['explicit']:.7f}"
            f" / {first['fused']:.7f} (|d| {d:.3g}) ({card}) {at()}")
        check(d <= 1e-5 + 1e-4 * abs(first["explicit"]),
              f"fused pads off explicit pads ({dtype}): {first}")

    # the ConvTranspose decoder: one step on the card against the CPU
    cpu_b = {k: v.cpu() for k, v in batch32.items()}
    results = {}
    for label, where, b in (("card", dev, batch32), ("cpu", torch.device("cpu"), cpu_b)):
        model = ModelB2(bilinear=False)
        state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(3),
                                   device=where)
        step = make_train_step(model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD)
        t = time.perf_counter()
        _, m = step(state, b)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        results[label] = ({k: float(v) for k, v in m.items()}, step_record(model))
        if label == "card":
            K.reset_launches()
            ct_ms = time_ms(torch, lambda: step(state, batch32), 10)
            launches["train_convtranspose"] = counts()
        else:
            cpu_s = first_s
        del model, state, step
    (mc, sc), (mp, sp) = results["card"], results["cpu"]
    diffs = step_diffs(sc, sp)
    loss_d = {k: abs(mc[k] - mp[k]) / max(1.0, abs(mp[k])) for k in mp}
    log(f"ConvTranspose ModelB2 (bilinear=False, full width, batch 32): {ct_ms:.3f} ms a step "
        f"on the card, {cpu_s:.2f} s on the CPU; card vs CPU metrics {loss_d}, {diffs} "
        f"({card}) {at()}")
    # the metrics of the step's forward within the golden step's 5e-5 (phase 7)
    check(max(loss_d.values()) < 5e-5 and step_diffs_ok(diffs, converged=False),
          "the ConvTranspose step on the card is off the CPU's")

    # data parallelism: two gloo ranks on this card against one process
    gpath = os.path.join(tmp, "granule.npz")
    np.savez(gpath, lst=granule[0], ndvi=granule[1])
    t = time.perf_counter()
    outs = run_dp_workers(dict(world=2, device="cuda", downchannels=[16, 32, 64, 128],
                               batch=32, hw=256, seed=5, weights=True, synthetic=True,
                               time_steps=5, granule=gpath,
                               serving="prow", granule_batch=N), tmp, timeout=400)
    t_dp = time.perf_counter() - t
    model = ModelB2()
    state = create_train_state(model, 1e-3, device=dev, variables=load_variables(
        os.path.join(ROOT, "weights", "modelB_1009")))
    step = make_train_step(model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD)
    b = {k: torch.from_numpy(v).to(dev) for k, v in dp_batch(32, 256, 5, synthetic=True).items()}
    _, m = step(state, b)
    single = step_record(model)
    single_ms = time_ms(torch, lambda: step(state, b), 10)
    o0, o1 = outs
    same = all(np.array_equal(o0[k], o1[k]) for k in o0
               if k.startswith(("state/", "metric/")))
    diffs = step_diffs(o0, single)
    loss_d = {k: abs(float(o0["metric/" + k]) - float(v)) / max(1.0, abs(float(v)))
              for k, v in m.items()}
    bound = {k: 1e-6 if "loss" in k else 1e-5 for k in loss_d}   # PSNR, SSIM: 1e-5
    grans = [json.loads(str(o["granule_launches"])) for o in outs]
    want = {k.__name__: 0 for k in K.KERNELS}
    want.update(prow_per_batch)
    log(f"data parallel, 2 gloo ranks on one card (16 of 32 each): ranks identical {same}; "
        f"against one process on 32: metrics {loss_d}, {diffs}; kernel M launches a rank {o0['m_launches'].tolist()}; step "
        f"{float(o0['step_ms']):.3f} / {float(o1['step_ms']):.3f} ms a rank (host clock; one "
        f"process on 32: {single_ms:.3f} ms on the device; not a scaling figure); "
        f"predict_granule(mesh) prow mosaic {o0['mosaic_digest']} / {o1['mosaic_digest']} "
        f"(no mesh {prow_digest}), launches a rank {grans[0]}; {t_dp:.1f} s for the ranks "
        f"({card}) {at()}")
    check(same and all(loss_d[k] < bound[k] for k in loss_d)
          and step_diffs_ok(diffs, converged=True)
          and o0["m_launches"].tolist() == o1["m_launches"].tolist() == [1, 1],
          "the data-parallel step is off the single-process one")
    check(str(o0["mosaic_digest"]) == str(o1["mosaic_digest"]) == prow_digest
          and grans[0] == grans[1] == want,
          "predict_granule(mesh=...) is off predict_granule")
    launches["train_dp_rank0"] = {k: int(v) for k, v in zip(
        ("fused_psf_downscale", "fused_psf_downscale_backward"), o0["m_launches"])}
    launches["granule_dp_rank0"] = grans[0]
    if failures:
        raise AssertionError(f"phase 11 failed: {failures}")
    return launches


def write_strip_tiff(path: str, arr: np.ndarray, rows_per_strip: int | None = None,
                     deflate: bool = False) -> None:
    """A single-band little-endian classic TIFF in strips of
    ``rows_per_strip`` rows (all rows by default), each strip raw or
    deflate-compressed (compression 8, no predictor): the two layouts the
    native loader decodes. ``geo.tiff.write_geotiff`` writes one raw strip."""
    import struct
    import zlib

    arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
    h, w = arr.shape
    rps = rows_per_strip or h
    strips = [arr[r:r + rps].tobytes() for r in range(0, h, rps)]
    if deflate:
        strips = [zlib.compress(s) for s in strips]
    offsets, off = [], 8
    for s in strips:
        offsets.append(off)
        off += len(s)
    n = len(strips)
    sample_format = {"f": 3, "i": 2, "u": 1}[arr.dtype.kind]
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 8 * arr.dtype.itemsize),
               (259, 3, 1, 8 if deflate else 1), (262, 3, 1, 1), (277, 3, 1, 1),
               (278, 3, 1, rps), (339, 3, 1, sample_format)]
    ifd_off = off
    tables = ifd_off + 2 + 12 * (len(entries) + 2) + 4
    tail = b""
    if n == 1:
        entries += [(273, 4, 1, offsets[0]), (279, 4, 1, len(strips[0]))]
    else:
        entries += [(273, 4, n, tables), (279, 4, n, tables + 4 * n)]
        tail = (b"".join(struct.pack("<I", o) for o in offsets)
                + b"".join(struct.pack("<I", len(s)) for s in strips))
    out = struct.pack("<2sHI", b"II", 42, ifd_off) + b"".join(strips)
    out += struct.pack("<H", len(entries))
    for tag, typ, count, val in sorted(entries):
        out += struct.pack("<HHII", tag, typ, count, val)
    out += struct.pack("<I", 0) + tail
    with open(path, "wb") as f:
        f.write(out)


def write_training_manifest(directory: str, n_train: int, n_val: int, seed: int = 0):
    """A manifest of seeded synthetic GeoTIFF pairs (a 64² Kelvin LST and a
    256² NDVI, ``make_synthetic_dataset``'s fields), Train then Val, in the
    reference's CSV layout, with its statistics JSON. Even pairs are raw
    strips (the LST one strip, the NDVI strips of 32 rows), odd pairs
    deflate strips of 16 rows. Returns (csv path, statistics path)."""
    import csv

    from sifsr_tpu_torch.data import denormalize, make_synthetic_dataset

    ds = make_synthetic_dataset(n_train + n_val, seed=seed)
    st = ds.stats
    lst = denormalize(ds.lst, st).astype(np.float32)
    ndvi = (ds.ndvi * st.std_ndvi + st.mean_ndvi).astype(np.float32)
    os.makedirs(directory, exist_ok=True)
    rows = []
    for i in range(n_train + n_val):
        deflate = i % 2 == 1
        lst_p = os.path.join(directory, f"{i:04d}_day_lst.tif")
        ndvi_p = os.path.join(directory, f"{i:04d}_day_ndvi.tif")
        write_strip_tiff(lst_p, lst[i], 16 if deflate else None, deflate)
        write_strip_tiff(ndvi_p, ndvi[i], 16 if deflate else 32, deflate)
        rows.append({"index": i, "LST": lst_p, "NDVI": ndvi_p,
                     "split": "Train" if i < n_train else "Val"})
    csv_path = os.path.join(directory, "manifest.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["index", "LST", "NDVI", "split"])
        w.writeheader()
        w.writerows(rows)
    stats_path = os.path.join(directory, "statistics.json")
    with open(stats_path, "w") as f:
        json.dump({"maxi": st.maxi, "mini": st.mini, "mean_lst": st.mean_lst,
                   "std_lst": st.std_lst, "mean_ndvi": st.mean_ndvi, "std_ndvi": st.std_ndvi}, f)
    return csv_path, stats_path


def dp_batch(n: int, hw: int, seed: int, synthetic: bool = False) -> dict:
    """A seeded predef_filters batch of ``n`` (NHWC float32 numpy): lst at
    (hw/4)², lst_up and ndvi at hw²; normal noise, or with ``synthetic``
    ``make_synthetic_dataset``'s fields (hw 256) with ``prepare_batch``'s
    bicubic x4 of the LST computed on the CPU."""
    if synthetic:
        from sifsr_tpu_torch.data import make_synthetic_dataset, prepare_batch

        raw = next(make_synthetic_dataset(n, seed=seed).batches(n))
        return {k: v.numpy() for k, v in prepare_batch(raw, device="cpu").items()}
    rng = np.random.default_rng(seed)
    return {"lst": rng.normal(size=(n, hw // 4, hw // 4, 1)).astype(np.float32),
            "lst_up": rng.normal(size=(n, hw, hw, 1)).astype(np.float32),
            "ndvi": rng.normal(size=(n, hw, hw, 1)).astype(np.float32)}


def dp_worker(spec_path: str) -> None:
    """One rank of a data-parallel run (``python chip_smoke.py --dp-worker
    SPEC.json``; phase 11 and tests/test_torch_parallel.py start them with
    ``run_dp_workers``). The JSON spec gives rank, world, port, device,
    downchannels, batch (global), hw, seed, threads and out, and optionally
    weights (start from weights/modelB_1009 instead of the seeded init),
    synthetic (``dp_batch``'s), bn, granule (an .npz of lst and ndvi),
    serving ('f32' or 'prow'), granule_batch, keep_mosaic, tail_granule (an
    .npz whose blocks leave a last batch that the group does not divide),
    tail_batch and time_steps.

    Joins a gloo group over tcp://127.0.0.1:port, replicates a seeded
    ModelB2, takes one predef_filters step on its shard of the global batch
    through ``make_parallel_train_step``, and writes an .npz: the metrics,
    the post-step state dict and kernel M's launches; with bn, a cross-rank
    BatchNorm's output, input gradient and running statistics on its shard
    of a seeded input (and the affine gradients summed over the ranks); with
    granule, ``predict_granule(mesh=...)``'s launches and mosaic digest (and
    the mosaic with keep_mosaic); with tail_granule, its mosaic at
    tail_batch and the rows this rank stepped (the ``rows`` counter of
    ``tracing``); with time_steps, the median ms of that many further steps
    (host clock, synchronised)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from sifsr_tpu_torch import kernels as K
    from sifsr_tpu_torch.models.unet import ModelB2
    from sifsr_tpu_torch.parallel import (CrossRankBatchNorm2d, make_mesh,
                                          make_parallel_train_step, replicate)
    from sifsr_tpu_torch.train import create_train_state, make_train_step

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=spec["world"], rank=spec["rank"],
                            timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh(device=spec["device"])
        dev = mesh.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        out = {"rank": mesh.rank, "size": mesh.size}
        model = ModelB2(downchannels=tuple(spec["downchannels"]))
        if spec.get("weights"):
            from sifsr_tpu_torch.cli.predict import load_variables

            state = create_train_state(model, 1e-3, device=dev, variables=load_variables(
                os.path.join(ROOT, "weights", "modelB_1009")))
        else:
            state = create_train_state(model, 1e-3,
                                       generator=torch.Generator().manual_seed(spec["seed"]),
                                       device=dev)
        replicate(model, mesh)
        step = make_parallel_train_step(
            make_train_step(model, "predef_filters", DP_ALPHA, DP_GAMMA, DP_MEAN, DP_STD,
                            mesh=mesh), mesh)
        batch = dp_batch(spec["batch"], spec["hw"], spec["seed"], spec.get("synthetic", False))
        K.reset_launches()
        state, metrics = step(state, batch)
        sync()
        out["m_launches"] = np.array([K.fused_psf_downscale.launches,
                                      K.fused_psf_downscale.backward_launches])
        for k, v in metrics.items():
            out[f"metric/{k}"] = np.float32(v.cpu())
        out.update(step_record(model))   # copies: later steps update the model in place
        if spec.get("time_steps"):
            times = []
            for _ in range(spec["time_steps"]):
                sync()
                t = time.perf_counter()
                step(state, batch)
                sync()
                times.append(1e3 * (time.perf_counter() - t))
            out["step_ms"] = np.float64(np.median(times))
        if spec.get("bn"):
            rng = np.random.default_rng(spec["seed"] + 1)
            x = rng.normal(1.5, 2.0, (4 * mesh.size, 3, 6, 5)).astype(np.float32)
            g = rng.normal(size=x.shape).astype(np.float32)
            rows = slice(4 * mesh.rank, 4 * mesh.rank + 4)
            bn = CrossRankBatchNorm2d(3, mesh).to(dev)
            with torch.no_grad():
                bn.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
                bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
            xl = torch.from_numpy(x[rows]).to(dev).requires_grad_()
            y = bn(xl)
            (y * torch.from_numpy(g[rows]).to(dev)).sum().backward()
            out["bn/y"] = y.detach().cpu().numpy()
            out["bn/x_grad"] = xl.grad.cpu().numpy()
            wb = torch.stack([bn.weight.grad, bn.bias.grad])
            dist.all_reduce(wb)   # each rank holds its shard's share of them
            out["bn/wb_grad"] = wb.cpu().numpy()
            out["bn/running_mean"] = bn.running_mean.cpu().numpy()
            out["bn/running_var"] = bn.running_var.cpu().numpy()
        if spec.get("granule"):
            from sifsr_tpu_torch.cli.predict import load_variables, make_quantized_step
            from sifsr_tpu_torch.data.statistics import Statistics
            from sifsr_tpu_torch.inference import predict_granule

            with np.load(spec["granule"]) as z:
                lst, ndvi = z["lst"], z["ndvi"]
            stats = Statistics.from_json(os.path.join(ROOT, "data", "statistics_testset.json"))
            variables = load_variables(os.path.join(ROOT, "weights", "modelB_1009"))
            kw = dict(compute_dtype=torch.float32, pad_impl="explicit")
            if spec.get("serving") == "prow":
                qstep, qparams = make_quantized_step(variables, lst, ndvi, stats,
                                                     use_pallas=True, device=dev)
                kw = dict(sr_step=qstep, step_params=qparams)
            K.reset_launches()
            mosaic = predict_granule(variables, lst, ndvi, stats,
                                     batch_size=spec["granule_batch"], mesh=mesh, **kw)
            sync()
            out["granule_launches"] = json.dumps({k.__name__: k.launches for k in K.KERNELS})
            out["mosaic_digest"] = digest(mosaic)
            if spec.get("keep_mosaic"):
                out["mosaic"] = mosaic
            if spec.get("tail_granule"):
                from sifsr_tpu_torch import tracing

                with np.load(spec["tail_granule"]) as z:
                    lst, ndvi = z["lst"], z["ndvi"]
                tracing.enable()
                out["tail_mosaic"] = predict_granule(variables, lst, ndvi, stats,
                                                     batch_size=spec["tail_batch"], mesh=mesh,
                                                     **kw)
                tracing.disable()
                (root,) = [r for r in tracing.records() if r["name"] == "predict_granule"]
                out["tail_rows"] = np.int64(root["counts"]["rows"])
        np.savez(spec["out"], **out)
    finally:
        dist.destroy_process_group()


def run_dp_workers(spec: dict, tmp: str, timeout: float = 600.0) -> list[dict]:
    """Start ``spec['world']`` ranks of ``dp_worker`` on a free localhost
    port, wait for each (``timeout`` seconds; a rank still running then is
    killed) and return their outputs in rank order. Raises if a rank
    failed, with the end of its log."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(spec["world"]):
        path = os.path.join(tmp, f"dp_spec_{rank}.json")
        with open(path, "w") as f:
            json.dump(dict(spec, rank=rank, port=port,
                           out=os.path.join(tmp, f"dp_out_{rank}.npz")), f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dp-worker", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=ROOT)))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("data-parallel ranks failed:\n" + "\n----\n".join(
            f"rank {r} rc {p.returncode}:\n{text[-4000:]}"
            for r, (p, text) in enumerate(zip(procs, logs))))
    outs = []
    for rank in range(spec["world"]):
        with np.load(os.path.join(tmp, f"dp_out_{rank}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def step_record(model) -> dict:
    """A model's state after a train step as numpy copies: ``state/<key>``
    for its state dict, ``grad/<name>`` for each parameter's gradient."""
    out = {f"state/{k}": v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    out.update({f"grad/{n}": p.grad.detach().cpu().numpy().copy()
                for n, p in model.named_parameters()})
    return out


def step_diffs(got: dict, want: dict) -> dict:
    """Two ``step_record``s of one train step taken two ways: ``grad_rel``,
    the L2 norm of the gradients' difference over the norm of ``want``'s;
    over the parameters after the step, the 0.999-quantile and max of the
    difference, overall and where |gradient| >= 1e-6 (``q999_well``,
    ``max_well``; ``n_well`` such parameters), and the 0.99-quantile; ``bn``,
    the BatchNorm running statistics' max difference (relative past 1).

    Adam's first update is lr * g / (|g| + eps): where a gradient is small
    enough that float32 summation noise flips its sign, the parameters move
    2 lr apart. At full width ~0.1-5 % of the gradients lie below 1e-6 (the
    ConvTranspose decoder's ``up`` biases, which a BatchNorm follows, near
    1e-10), and the same single-process step at 1 and 8 CPU threads is
    1.9e-3 apart at q999: the well-conditioned parameters (the golden
    step's threshold, tests/test_torch_train.py) are where two correct steps
    agree."""
    names = [k[len("grad/"):] for k in want if k.startswith("grad/")]
    gd = np.concatenate([(got["grad/" + n] - want["grad/" + n]).ravel() for n in names])
    g = np.concatenate([want["grad/" + n].ravel() for n in names])
    d = np.concatenate([np.abs(np.asarray(got["state/" + n], np.float64)
                               - want["state/" + n]).ravel() for n in names])
    well = np.abs(g) >= 1e-6
    bn = max(float((np.abs(np.asarray(got[k], np.float64) - v) / np.maximum(1.0, np.abs(v))).max())
             for k, v in want.items() if k.endswith(("running_mean", "running_var")))
    return {"grad_rel": float(np.linalg.norm(gd) / np.linalg.norm(g)),
            "q99": float(np.quantile(d, 0.99)), "q999": float(np.quantile(d, 0.999)),
            "max": float(d.max()),
            "q999_well": float(np.quantile(d[well], 0.999)), "max_well": float(d[well].max()),
            "n_well": int(well.sum()), "bn": bn}


def step_diffs_ok(diffs: dict, converged: bool) -> bool:
    """The bounds phase 11 holds two full-width steps to.

    ``converged``, from weights/modelB_1009 on realistic fields (the same
    step at 1 and 8 CPU threads, batch 8: gradients 3.0-7.6e-5 apart in
    relative L2, parameters q999 4.6e-5, 1.0e-6 where |gradient| >= 1e-6):
    gradients within 5e-4, the golden step's bounds on the parameters
    (tests/test_torch_train.py: q999 < 1e-4, within 2e-5 where |gradient|
    >= 1e-6, over 50,000 of them, at most 2 lr apart), BatchNorm statistics
    within 5e-5 (relative past 1).

    Else, from a seeded init (no trained ConvTranspose model exists): the
    float32 gradients of one step differ by 1.0-5.2e-3 between 1 and 8 CPU
    threads, as ReLUs near zero flip, and Adam's first update moves 0.1 %
    of the parameters 2 lr apart (q99 6.5e-5); held: gradients within 3e-2,
    parameters at q99 < 3e-4 and at most 2 lr apart, BatchNorm statistics
    within 5e-5."""
    common = diffs["max"] <= 2e-3 + 1e-6 and diffs["bn"] < 5e-5
    if converged:
        return (common and diffs["grad_rel"] < 5e-4 and diffs["q999"] < 1e-4
                and diffs["max_well"] < 2e-5 and diffs["n_well"] > 50_000)
    return common and diffs["grad_rel"] < 3e-2 and diffs["q99"] < 3e-4


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler table of three train steps")
    parser.add_argument("--dp-worker", metavar="SPEC", default=None,
                        help="run one rank of a data-parallel run (dp_worker) and exit")
    args = parser.parse_args()
    if args.dp_worker:
        dp_worker(args.dp_worker)
    else:
        main(args.profile)
