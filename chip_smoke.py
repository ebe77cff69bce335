#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``sifsr_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (no result line is printed then):

1. device: the card's name and power limit (nvidia-smi);
2. build: every ``sifsr_tpu_torch/csrc/*.cu`` by nvcc for sm_90a, in
   parallel;
3. kernels: each hand-written kernel of the int8 serving path at the shapes
   the path gives it (batch 324), held against its plain PyTorch version on
   the same seeded inputs: the outputs must be identical (int8 and the
   generic conv's float32 alike); CUDA-event times of kernel and plain
   version, and the least time the card could take (bytes or operations);
4. float anchor: ModelB2 in float32 (TF32 off) vs the reference torch
   outputs in golden/ at rtol 1e-4 / atol 5e-5;
5. whole granule: a seeded synthetic 1200² LST / 4800² NDVI granule through
   ``predict_granule`` at batch 324 with the float32 step, the bf16 step
   (``predict_granule``'s default) and the int8 step
   (``make_quantized_step(..., use_pallas=True)``). The bf16 mosaic must
   stay within RMSE 0.1 K / max 0.5 K of the float32 one (the bound of the
   port's CPU test of the bf16 step); the int8 mosaic within RMSE 0.3 K /
   max 1 K, inside 250-350 K, and the launch counters, zeroed just before the int8 run,
   must show every kernel of the path ran (per batch: upsample_phases 2,
   conv_i8_exact 2, conv_i8_exact_dual 1, conv_i8_in1_split 1,
   conv_i8_generic 14).

The second-to-last line is the kernels JSON, the last
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one, or without the repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 324                      # predict's batch: one 1200² granule = 18x18 blocks
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    sys.path.insert(0, ROOT)
    from sifsr_tpu_torch import kernels as K
    from sifsr_tpu_torch.cli.predict import load_variables, make_quantized_step
    from sifsr_tpu_torch.data.statistics import Statistics
    from sifsr_tpu_torch.inference import predict_granule
    from sifsr_tpu_torch.kernels import _build, conv_i8, resize_phases
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

    def check(name, calls, reps=10, plain_reps=2):
        """calls: [(kernel_fn, plain_fn, nbytes, ops, ops_rate)] -- the kernel's
        work in one serving batch."""
        err, ms, plain_ms, b_ms, ops_ms = 0.0, 0.0, 0.0, 0.0, 0.0
        for kern, plain, nbytes, ops, rate in calls:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
                err = max(err, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
            del got, want
            k_ms, p_ms = time_ms(torch, kern, reps), time_ms(torch, plain, plain_reps)
            ms += k_ms
            plain_ms += p_ms
            b_ms += nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms += ops / rate * 1e3
            log(f"  {name} call: {k_ms:.4f} ms (plain {p_ms:.2f} ms), bytes bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, ops bound {ops / rate * 1e3:.4f} ms")
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain version, max|d| = {err}")
        entries[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=max(b_ms, ops_ms),
                             bound_by="bytes" if b_ms >= ops_ms else "operations",
                             calls=len(calls))
        log(f"kernel {name}: {len(calls)} call(s)/batch, identical to plain; "
            f"{ms:.4f} ms (plain {plain_ms:.2f} ms, bound {max(b_ms, ops_ms):.4f} ms)")

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
                nbytes, ops, F32_OPS_PER_S)

    check("upsample_phases", [up_call(lst_n, 4, "cubic", 0.02),
                              up_call(mid_out, 2, "linear_ac", 0.025)])

    # D: inbloc.conv1, LST and NDVI int8 planes -> 16 channels at 256²
    x2, w1, sc1, b1 = conv_args(2, 16, (N, 256, 256))
    lst_q, ndvi_q = x2[..., 0].contiguous(), x2[..., 1].contiguous()
    del x2
    check("conv_i8_in1_split", [(
        lambda: K.conv_i8_in1_split(lst_q, ndvi_q, w1, sc1, b1),
        lambda: conv_i8.conv_i8_in1_split_plain(lst_q, ndvi_q, w1, sc1, b1),
        conv_bytes(N, 256, 256, 2, 16, 1), conv_ops(N, 256, 256, 2, 16), INT8_OPS_PER_S)])
    del lst_q, ndvi_q

    # B: inbloc.conv2 with the fused phase mean, ub3.conv2 without
    x, w, sc, b = conv_args(16, 16, (N, 256, 256))
    pm_scale = float(np.float32(0.9) / np.float32(4.0))
    check("conv_i8_exact", [
        (lambda: K.conv_i8_exact(x, w, sc, b, pm_scale=pm_scale),
         lambda: conv_i8.conv_i8_exact_plain(x, w, sc, b, pm_scale=pm_scale),
         conv_bytes(N, 256, 256, 16, 16, 1) + N * 128 * 128 * 16,
         conv_ops(N, 256, 256, 16, 16), INT8_OPS_PER_S),
        (lambda: K.conv_i8_exact(x, w, sc, b),
         lambda: conv_i8.conv_i8_exact_plain(x, w, sc, b),
         conv_bytes(N, 256, 256, 16, 16, 1), conv_ops(N, 256, 256, 16, 16), INT8_OPS_PER_S)])

    # C: ub3.conv1 over concat(up, s0)
    z, wz, scz, _ = conv_args(16, 16, (N, 256, 256))
    check("conv_i8_exact_dual", [(
        lambda: K.conv_i8_exact_dual(x, z, w, wz, sc, scz, b),
        lambda: conv_i8.conv_i8_exact_dual_plain(x, z, w, wz, sc, scz, b),
        N * 256 * 256 * (16 + 16 + 16) + 2 * 9 * 16 * 16 + 12 * 16,
        2 * conv_ops(N, 256, 256, 16, 16), INT8_OPS_PER_S)])
    del x, z

    # generic: the 13 mid-chain convs and the outlay of one batch
    mid_shapes = ([(128, 16, 16)] * 2 + [(128, 16, 32)] + [(64, 32, 32)] * 2 + [(64, 32, 64)]
                  + [(32, 64, 64)] * 3 + [(64, 128, 64), (64, 64, 32), (128, 64, 32),
                                          (128, 32, 16), (256, 16, 1)])
    generic_calls = []
    for hw, cin, cout in mid_shapes:
        gx, gw, gs, gb = conv_args(cin, cout, (N, hw, hw))
        relu = cout != 1
        generic_calls.append((
            (lambda gx=gx, gw=gw, gs=gs, gb=gb, relu=relu: K.conv_i8_generic(gx, gw, gs, gb, relu)),
            (lambda gx=gx, gw=gw, gs=gs, gb=gb, relu=relu:
             conv_i8.conv_i8_generic_plain(gx, gw, gs, gb, relu)),
            conv_bytes(N, hw, hw, cin, cout, 4), conv_ops(N, hw, hw, cin, cout), INT8_OPS_PER_S))
    check("conv_i8_generic", generic_calls, reps=5, plain_reps=1)
    del generic_calls
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

    def run(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = predict_granule(variables, lst, ndvi, stats, batch_size=N, device=dev, **kw)
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
    run(sr_step=step, step_params=qparams)
    K.reset_launches()
    sr, t_i8 = run(sr_step=step, step_params=qparams)
    launches = {k.__name__: k.launches for k in K.KERNELS}
    n_blocks = (lst.shape[0] // 64) * (lst.shape[1] // 64)
    n_batches = -(-n_blocks // N)
    want = {"upsample_phases": 2, "conv_i8_exact": 2, "conv_i8_exact_dual": 1,
            "conv_i8_in1_split": 1, "conv_i8_generic": 14}
    for name, per_batch in want.items():
        if launches[name] != per_batch * n_batches:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {per_batch * n_batches}: {launches}")
    mosaic = (256 * (lst.shape[0] // 64), 256 * (lst.shape[1] // 64))  # partial blocks drop
    assert ref.shape == sr.shape == mosaic, (ref.shape, sr.shape)
    assert np.isfinite(sr).all() and np.isfinite(ref).all()
    d = sr.astype(np.float64) - ref
    rmse, dmax = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
    log(f"granule: int8 vs f32 RMSE {rmse:.4f} K, max {dmax:.4f} K, "
        f"int8 range {sr.min():.2f}..{sr.max():.2f} K")
    if not (rmse < 0.3 and dmax < 1.0 and sr.min() > 250.0 and sr.max() < 350.0
            and ref.min() > 250.0 and ref.max() < 350.0):
        raise AssertionError(f"int8 contract failed: rmse {rmse}, max {dmax}, "
                             f"range {sr.min()}..{sr.max()}")

    # device time of one serving batch for each step
    lst_d = torch.from_numpy(lst[:64 * 18, :64 * 18].reshape(18, 64, 18, 64)
                             .transpose(0, 2, 1, 3).reshape(N, 64, 64).copy()).to(dev)
    ndvi_d = torch.from_numpy(np.clip(ndvi, -1, 1)[:256 * 18, :256 * 18].reshape(18, 256, 18, 256)
                              .transpose(0, 2, 1, 3).reshape(N, 256, 256).copy()).to(dev)
    from sifsr_tpu_torch.inference import make_sr_step
    from sifsr_tpu_torch.models.fused import InferenceModelB2

    fmodel = InferenceModelB2.from_variables(variables).to(dev)
    f_step = make_sr_step(stats, torch.float32, dev)
    ms_f32 = time_ms(torch, lambda: f_step(fmodel, lst_d, ndvi_d), 5)
    bmodel = InferenceModelB2.from_variables(variables).to(dev, torch.bfloat16)
    b_step = make_sr_step(stats, torch.bfloat16, dev)
    ms_bf16 = time_ms(torch, lambda: b_step(bmodel, lst_d, ndvi_d), 5)
    ms_i8 = time_ms(torch, lambda: step(qparams, lst_d, ndvi_d), 10)
    log(f"granule f32: {n_blocks / t_f32:.1f} patches/s wall ({t_f32:.3f} s), "
        f"step {ms_f32:.3f} ms/batch of {N} on device")
    log(f"granule bf16: {n_blocks / t_bf16:.1f} patches/s wall ({t_bf16:.3f} s), "
        f"step {ms_bf16:.3f} ms/batch of {N} on device")
    log(f"granule int8: {n_blocks / t_i8:.1f} patches/s wall ({t_i8:.3f} s), "
        f"step {ms_i8:.3f} ms/batch of {N} on device; calibration {t_cal:.2f} s")
    log(f"launches in the int8 granule run: {launches}")

    src = "sifsr_tpu_torch/csrc/"
    meta = {
        "upsample_phases": (src + "resize_phases.cu", "sifsr_tpu/pallas/resize_phases.py:93"),
        "conv_i8_in1_split": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:732"),
        "conv_i8_exact": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:333"),
        "conv_i8_exact_dual": (src + "conv_i8.cu", "sifsr_tpu/pallas/conv_i8.py:395"),
        "conv_i8_generic": (src + "conv_i8.cu", "sifsr_tpu/models/quantized_packed.py:66"),
    }
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
         "library_ms": None, "calls_per_batch": e["calls"]}
        for name, e in entries.items()]}
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


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
    main()
