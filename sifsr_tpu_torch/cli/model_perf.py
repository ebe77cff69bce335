"""ASTER evaluation CLI (model_perf_aster_formatds.py rebuilt).

    python -m sifsr_tpu_torch.cli.model_perf --sr-type modelB \
        --model-dir weights/modelB_1009 --dataset DIR --serving prow --device-metrics

Port of ``sifsr_tpu/cli/model_perf.py``, same flags and defaults, plus
``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain version
and the metric block on the host). Writes <out>/performances.csv with the
reference's column and aggregate-row layout (``eval.harness``).

``--sr-type modelB`` runs ModelB2 on the card, one pair a call, through a
serving path (``--serving``): ``f32`` (ModelB2 in eval mode, float32, TF32
off; ``--scale-invariance`` runs it on the 16 64² tiles of the pair),
``bf16`` (``inference.make_sr_step``, BN-folded, fused pads), ``int8``
(``models.quantized``), ``pallas`` and ``prow`` (``models.int8_serving``
with ``mid='xla'`` and the default ``mid='prow'``, the hand-written
kernels). The quantised paths calibrate their static scales on the first
``--calib-pairs`` usable pairs of the dataset. ``--sr-type bicubic`` is the
floor method. The classical baselines: ``TsHARP``, ``ATPRK`` and ``AATPRK``
run on the host in numpy and scipy, on a coarse NDVI pooled in numpy with
the bits of the JAX package's norm-L4 pooling (``_coarse_ndvi``); ``DMS``
fits and applies its bagged regression trees and its residual correction's
bicubic x4 on ``--device`` (``baselines.forest``), the rest in numpy
(``--dms-moving-window`` turns on its moving-window local regressors).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from sifsr_tpu_torch.device import full_f32, resolve_device

__all__ = ["SR_TYPES", "SERVING_PATHS", "make_sr_fn", "main"]

SR_TYPES = ("modelB", "bicubic", "TsHARP", "ATPRK", "AATPRK", "DMS")

SERVING_PATHS = ("f32", "bf16", "int8", "pallas", "prow")


def _load_calibration_pairs(dataset: str, n: int = 32):
    """First n usable test pairs, for the quantized paths' static activation
    calibration (static per-tensor scales, the methodology behind
    results/modelB_1009_{int8,pallas*}; see EVAL_RESULTS.md). Calibration is
    one float32 forward over the batch, so a wider set costs seconds and
    tightens the max-abs scales."""
    import pandas as pd

    from sifsr_tpu_torch.eval.harness import load_test_pair

    manifest = pd.read_csv(os.path.join(dataset, "dataset.csv"))
    lsts, ndvis = [], []
    for _, row in manifest.iterrows():
        pair = load_test_pair(
            os.path.join(dataset, "data", os.path.basename(row["MODIS patch"])))
        if pair.ndvi.shape != (256, 256):
            continue
        lsts.append(pair.lst.astype(np.float32))
        ndvis.append(pair.ndvi.astype(np.float32))
        if len(lsts) == n:
            break
    if not lsts:
        raise ValueError(f"no usable calibration pairs in {dataset}")
    return np.stack(lsts), np.stack(ndvis)


def _coarse_ndvi(ndvi: np.ndarray, factor: int = 4) -> np.ndarray:
    """TsHARP's, ATPRK's and AATPRK's coarse NDVI: the norm-L4 pooling of
    ``ops.pooling.norm_l4_downsample`` in float32, clipped to [-1, 1], with
    the bits of ``jnp``'s on XLA:CPU (each block's fourth powers added one at
    a time in row-major order, each root correctly rounded). AATPRK's
    windowed regressions carry an ulp of the coarse NDVI past 1e-3 K."""
    x = np.asarray(ndvi, np.float32)
    h, w = x.shape
    x4 = np.square(np.square(x.reshape(h // factor, factor, w // factor, factor)))
    total = x4[:, 0, :, 0]
    for i in range(factor):
        for j in range(factor):
            if i or j:
                total = total + x4[:, i, :, j]
    mean = total / np.float32(factor * factor)
    root = np.sqrt(np.sqrt(mean.astype(np.float64)).astype(np.float32).astype(np.float64))
    return np.clip(root.astype(np.float32), -1, 1)


def make_sr_fn(sr_type: str, model_dir: str, statistics: str, scale_invariance: bool = False,
               dms_moving_window: int = 0, serving: str = "f32",
               dataset: str | None = None, calib_pairs: int = 32,
               calib_quantile: float | None = None, up2_impl: str = "mxu",
               device: str | torch.device = "cuda"):
    """Build sr_fn(lst Kelvin (64,64), ndvi (256,256)) -> (256,256) Kelvin,
    a numpy array, running on ``device``.

    serving (modelB only): 'f32' reference path, or a fast serving path:
    'bf16' (BN-folded bf16 forward), 'int8' (static-calibrated int8 convs),
    'pallas' (the int8 step with mid='xla'), 'prow' (the int8 step of the
    hand-written kernels, predict --pallas's default). Quantized paths
    calibrate on the first `calib_pairs` usable pairs of `dataset`."""
    if sr_type not in SR_TYPES:
        raise ValueError(f"sr_type must be one of {SR_TYPES}, got {sr_type!r}")
    if serving not in SERVING_PATHS:
        raise ValueError(f"serving must be one of {SERVING_PATHS}, got {serving!r}")
    dev = resolve_device(device)
    if sr_type == "bicubic":
        from sifsr_tpu_torch.baselines import bicubic_sr

        return lambda lst, ndvi: bicubic_sr(lst)
    if sr_type in ("TsHARP", "ATPRK", "AATPRK"):
        from sifsr_tpu_torch.baselines import aatprk, atprk, tsharp

        if sr_type == "TsHARP":
            return lambda lst, ndvi: tsharp(lst, _coarse_ndvi(ndvi), ndvi, 4, min_t=273)
        method = atprk if sr_type == "ATPRK" else aatprk
        return lambda lst, ndvi: method(lst, _coarse_ndvi(ndvi), ndvi, scale=4, scc=926,
                                        block_size=5, min_t=273)
    if sr_type == "DMS":
        from sifsr_tpu_torch.baselines import dms_sharpen

        return lambda lst, ndvi: dms_sharpen(
            lst, ndvi, factor=4, moving_window_size=dms_moving_window, device=dev)

    from sifsr_tpu_torch.cli.predict import load_variables
    from sifsr_tpu_torch.data.statistics import Statistics

    stats = Statistics.from_json(statistics)
    variables = load_variables(model_dir)

    if serving != "f32":
        if scale_invariance:
            raise ValueError("--serving fast paths are 256x256-input "
                             "serving graphs; SC-Unet eval is f32-only")
        if serving == "bf16":
            from sifsr_tpu_torch.inference import make_sr_step
            from sifsr_tpu_torch.models.fused import InferenceModelB2

            bmodel = InferenceModelB2.from_variables(variables).to(dev, torch.bfloat16)
            bstep = make_sr_step(stats, torch.bfloat16, dev, "fused")

            def fn(lst, ndvi):
                return bstep(bmodel, np.asarray(lst, np.float32)[None],
                             np.asarray(ndvi, np.float32)[None])[0].cpu().numpy()

            return fn
        cal_lst, cal_ndvi = _load_calibration_pairs(dataset, calib_pairs)
        if serving == "int8":
            from sifsr_tpu_torch.models.quantized import (
                calibrate_activation_scales,
                make_int8_sr_step,
                quantize_serving_params,
            )

            params = calibrate_activation_scales(
                variables, quantize_serving_params(variables, dev), cal_lst, cal_ndvi, stats,
                calib_quantile=calib_quantile, device=dev)
            step = make_int8_sr_step(stats, dev)
        else:
            from sifsr_tpu_torch.models.int8_serving import (
                build_int8_serving_params,
                make_int8_sr_step,
            )

            params = build_int8_serving_params(variables, cal_lst, cal_ndvi, stats,
                                               calib_quantile=calib_quantile, device=dev,
                                               up2_impl=up2_impl)
            step = make_int8_sr_step(stats, mid="prow" if serving == "prow" else "xla",
                                     device=dev)

        def fn(lst, ndvi):
            return step(params, np.asarray(lst, np.float32)[None],
                        np.asarray(ndvi, np.float32)[None])[0].cpu().numpy()

        return fn

    from sifsr_tpu_torch.models.unet import ModelB2
    from sifsr_tpu_torch.ops.resize import upsample_bicubic

    model = ModelB2()
    model.load_state_dict(variables, strict=True)
    model = model.to(dev).eval()

    @torch.no_grad()
    def forward(lst_up_n, ndvi_n):
        """(B, 256|64, ...) normalised inputs -> Kelvin (B, H, W) on the host."""
        x = torch.stack([lst_up_n, ndvi_n], dim=-1)
        with full_f32():
            sr = model(x)[..., 0]
        return (sr * stats.std_lst + stats.mean_lst).cpu().numpy()

    def normalised(lst, ndvi):
        lst_n = (torch.as_tensor(np.asarray(lst, np.float32), device=dev)
                 - stats.mean_lst) / stats.std_lst
        ndvi_n = (torch.as_tensor(np.asarray(ndvi, np.float32), device=dev)
                  - stats.mean_ndvi) / stats.std_ndvi
        with full_f32():
            return upsample_bicubic(lst_n[None], 4)[0], ndvi_n

    if scale_invariance:
        # the SC-Unet model runs on the 16 64x64 tiles of the 256x256 inputs
        # (reference model_perf_aster_formatds.py:192-200)
        def fn(lst, ndvi):
            lst_up, ndvi_n = normalised(lst, ndvi)

            def tiles(a):
                return a.reshape(4, 64, 4, 64).permute(0, 2, 1, 3).reshape(16, 64, 64)

            sr = forward(tiles(lst_up), tiles(ndvi_n))
            return sr.reshape(4, 4, 64, 64).transpose(0, 2, 1, 3).reshape(256, 256)

        return fn

    def fn(lst, ndvi):
        lst_up, ndvi_n = normalised(lst, ndvi)
        return forward(lst_up[None], ndvi_n[None])[0]

    return fn


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--sr-type", default="modelB", choices=SR_TYPES)
    parser.add_argument("--model-dir", default="weights/modelB_1009")
    parser.add_argument("--dataset", default="./test_data_formatted")
    parser.add_argument("--statistics", default="data/statistics.json")
    parser.add_argument("--out", default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--scale-invariance", action="store_true",
                        help="tile 64x64 through the model (SC-Unet eval mode)")
    parser.add_argument("--vgg16-weights", default=None)
    parser.add_argument("--lpips-weights", default=None)
    parser.add_argument("--save-pairs", action="store_true",
                        help="pickle per-pair crops for cli.compare_methods")
    parser.add_argument("--figures", action="store_true",
                        help="write 4-panel comparison PNGs per pair")
    parser.add_argument("--dms-moving-window", type=int, default=0,
                        help="DMS movingWindowSize in coarse px (0 = the reference's "
                             "patch-eval configuration, no local regressors)")
    parser.add_argument("--up2-impl", default="mxu", choices=["mxu", "vpu"],
                        help="pallas/prow only: the fused x2 upsamples' rounding chain, "
                             "'mxu' integer-exact row mix (default) or 'vpu' the float32 "
                             "chain of upsample_phases")
    parser.add_argument("--serving", default="f32", choices=SERVING_PATHS,
                        help="modelB serving path: f32 reference, bf16 "
                             "(BN-folded), or a quantized path (int8 / pallas / prow, "
                             "the hand-written kernels predict --pallas uses) statically "
                             "calibrated on the first --calib-pairs usable test pairs")
    parser.add_argument("--calib-pairs", type=int, default=32,
                        help="pairs used for quantized-path activation "
                             "calibration (one float32 forward; wider = tighter scales)")
    parser.add_argument("--calib-quantile", type=float, default=0.9999,
                        help="clip activation scales to this quantile of "
                             "|x| over the calibration batch instead of "
                             "max|x| (pass 1.0 for max-abs)")
    parser.add_argument("--device-metrics", action="store_true",
                        help="score the whole metric block (PSNR/SSIM/GSSIM/"
                             "stratified RMSE/RMSE_grad) for ALL pairs in "
                             "one batched device call (padded/masked batch "
                             "over the variable-shape crops) instead of "
                             "per-pair host numpy")
    parser.add_argument("--crop", default="erosion",
                        choices=["erosion", "reference"],
                        help="common-area crop: 'erosion' (ramp-free, "
                             "default) or 'reference' (the script's verbatim "
                             "200K/230K corner crop, "
                             "model_perf_aster_formatds.py:360-369)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args = parser.parse_args(argv)

    from sifsr_tpu_torch.eval.harness import run_evaluation
    from sifsr_tpu_torch.eval.lpips import LPIPS

    device = resolve_device(args.device)
    sr_fn = make_sr_fn(args.sr_type, args.model_dir, args.statistics, args.scale_invariance,
                       dms_moving_window=args.dms_moving_window, serving=args.serving,
                       dataset=args.dataset,
                       calib_pairs=args.calib_pairs,
                       calib_quantile=(None if args.calib_quantile >= 1.0
                                       else args.calib_quantile),
                       up2_impl=args.up2_impl, device=device)
    lpips = LPIPS(args.vgg16_weights, args.lpips_weights, device=device)
    if not lpips.available:
        print("LPIPS weights not found offline — LPIPS column will be NaN")

    sub = args.sr_type if args.serving == "f32" else f"{args.sr_type}_{args.serving}"
    out_dir = args.out or os.path.join(args.dataset, "results", sub)
    df = run_evaluation(
        args.dataset,
        sr_fn,
        output_csv=os.path.join(out_dir, "performances.csv"),
        lpips_metric=lpips if lpips.available else None,
        limit=args.limit,
        save_pairs_dir=out_dir if args.save_pairs else None,
        figures_dir=os.path.join(out_dir, "figures") if args.figures else None,
        crop_mode=args.crop,
        device_metrics=args.device_metrics,
        device=device,
    )
    print("|-------- Statistics --------|")
    print(df.loc["mean"])
    return df


if __name__ == "__main__":
    main()
