"""Whole-granule SR prediction CLI (reference predict.py rebuilt).

    python -m sifsr_tpu_torch.cli.predict \
        --MOD21A1D_file_path granule_lst.hdf|.tif \
        --MOD09GQ_file_path granule_refl.hdf|.tif ...

Port of ``sifsr_tpu/cli/predict.py``, same flags, defaults and messages,
plus ``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain
version). Inputs may be MODIS .hdf granules (decoded by geo.hdf4) or GeoTIFFs
(LST in Kelvin; for MOD09GQ a precomputed NDVI tif via --ndvi_is_precomputed,
a NIR/Red pair as two files, or one chunky 2-band tif in MOD09GQ band order
Red,NIR, e.g. a GDAL conversion). Output: predictions/prediction.tiff,
georeferenced from the input's geotransform.

The reference SRs the granule block by block at batch 1 on the host
(predict.py:84-103); here all 324 blocks go through batched steps on the card
(sifsr_tpu_torch.inference). ``--pallas`` is the int8 step with the
hand-written CUDA kernels (``models.int8_serving``; the flag keeps the JAX
CLI's name), ``--int8`` the plain int8 step of ``models.quantized``.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from sifsr_tpu_torch.data.ingest import compute_ndvi
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.geo.tiff import read_geotiff, write_geotiff
from sifsr_tpu_torch.inference import predict_granule, tile_granule
from sifsr_tpu_torch.models.convert import from_jax_variables, load_msgpack_variables

__all__ = ["load_variables", "make_quantized_step", "main"]


def _no_serving_step(what: str, network: str) -> ValueError:
    return ValueError(f"{what} is a {network} model: {network} has no serving step yet "
                      "(cli.predict, cli.serve and cli.model_perf serve ModelB_2); "
                      "cli.train trains it")


def _trained_network(params_json: str) -> str | None:
    """The ``"model"`` a run's params file names, where it names one."""
    if not os.path.exists(params_json):
        return None
    with open(params_json) as f:
        return json.load(f).get("model")


def load_variables(model_dir: str, model_name: str = "modelB") -> dict:
    """ModelB2 state dict from ``<model_dir>/<model_name>_variables.msgpack``
    (the flax tree), else from a reference ``<model_name>_state_dict.pt``
    (keys holding "factor", left by an older model revision, are dropped as
    the reference's predict.py:56-64 does). The files of a network with no
    serving step raise ``ValueError``, naming it, since only ModelB_2 has
    one: where ``<model_name>_train_params.json`` says ``"model": "SwinIR"``
    or ``"HAT"``, or the state dict holds their ``conv_first`` (HAT's also
    its ``overlap_attn``)."""
    params = os.path.join(model_dir, f"{model_name}_train_params.json")
    network = _trained_network(params)
    if network not in (None, "ModelB_2"):
        raise _no_serving_step(params, network)
    msgpack = os.path.join(model_dir, f"{model_name}_variables.msgpack")
    torch_sd = os.path.join(model_dir, f"{model_name}_state_dict.pt")
    if os.path.exists(msgpack):
        return from_jax_variables(load_msgpack_variables(msgpack))
    if os.path.exists(torch_sd):
        sd = torch.load(torch_sd, map_location="cpu", weights_only=True)
        if "conv_first.weight" in sd:
            hat = any(".overlap_attn." in k for k in sd)
            raise _no_serving_step(torch_sd, "HAT" if hat else "SwinIR")
        return {k: v for k, v in sd.items() if "factor" not in k}
    raise FileNotFoundError(f"no weights under {model_dir}")


def make_quantized_step(variables, lst, ndvi, stats, use_pallas: bool,
                        calib_quantile: float | None = None, up2_impl: str = "mxu",
                        device: str | torch.device = "cuda"):
    """Build an int8 serving step, statically calibrated on up to 8
    fully-valid 64x64 blocks of the given granule. Returns (step, params).
    Shared by the predict CLI and the serving daemon.

    use_pallas=True is the port's int8 step with its hand-written kernels
    (``models.int8_serving``, mid='prow', for 64x64 LST blocks; the same
    params also serve ``make_int8_sr_step(stats, mid='xla')``). up2_impl:
    the x2 upsamples' rounding chain, 'mxu' (integer-exact row mix) or 'vpu'
    (the float32 chain of ``upsample_phases``), as in the JAX package.
    use_pallas=False is the plain int8 step of ``models.quantized``
    (``predict --int8``).

    calib_quantile defaults to None (max-abs scales, no clipping on the
    calibration blocks) because deployment granules can exceed the first
    granule's activation range; pass e.g. 0.9999 for tighter scales."""
    lst_b, ndvi_b, _ = tile_granule(lst, np.clip(ndvi, -1, 1))
    valid = (lst_b != 0).all(axis=(1, 2))
    sel = np.nonzero(valid)[0][:8]
    if sel.size == 0:
        raise ValueError(
            "quantized serving needs at least one fully-valid 64x64 LST block to "
            "calibrate activation scales on; this granule has none (every block "
            "contains 0 K fill): serve it with the float step, or calibrate on a "
            "different granule first")
    if use_pallas:
        from sifsr_tpu_torch.models.int8_serving import (
            build_int8_serving_params,
            make_int8_sr_step,
        )

        params = build_int8_serving_params(variables, lst_b[sel], ndvi_b[sel], stats,
                                           calib_quantile=calib_quantile, device=device,
                                           up2_impl=up2_impl)
        return make_int8_sr_step(stats, device=device), params
    from sifsr_tpu_torch.models.quantized import (
        calibrate_activation_scales,
        make_int8_sr_step,
        quantize_serving_params,
    )

    qparams = calibrate_activation_scales(
        variables, quantize_serving_params(variables, device), lst_b[sel], ndvi_b[sel], stats,
        calib_quantile=calib_quantile, device=device)
    return make_int8_sr_step(stats, device), qparams


def _single_band(g, what: str) -> np.ndarray:
    """Validate a GeoTIFF decoded for a single-band consumer: multi-band
    reads come back (H, W, S) (geo/tiff.py) and would mis-shape the tiling
    / normalisation downstream with a cryptic reshape error."""
    if g.array.ndim != 2:
        raise ValueError(
            f"{what} is a {g.array.shape[-1]}-band TIFF: expected a "
            "single-band raster"
        )
    return g.array


def _load_lst(path: str, time: str = "day"):
    """Load the 1 km LST granule. Raises ValueError on unusable input (the
    CLIs convert that to a clean exit; cli/serve.py isolates it per job)."""
    if path.endswith((".tif", ".tiff")):
        g = read_geotiff(path)
        return _single_band(g, "the LST input").astype(np.float32), g.geotransform
    from sifsr_tpu_torch.geo.hdf4 import read_modis_lst

    return read_modis_lst(path, time=time)


def _load_ndvi(path: str, red_path: str | None, precomputed: bool):
    """Load / compute the 250 m NDVI. Raises ValueError on unusable input."""
    if path.endswith((".tif", ".tiff")):
        if precomputed:
            g = read_geotiff(path)
            return (_single_band(g, "the precomputed-NDVI input")
                    .astype(np.float32), g.geotransform)
        nir = read_geotiff(path)
        if nir.array.ndim == 3:
            if nir.array.shape[-1] != 2 or red_path is not None:
                raise ValueError(
                    f"--MOD09GQ_file_path is a {nir.array.shape[-1]}-band "
                    "tif: expected exactly 2 bands (Red, NIR) and no "
                    "--red_file_path alongside it"
                )
            # one chunky 2-band file in MOD09GQ band order:
            # band 1 = sur_refl_b01 (Red), band 2 = sur_refl_b02 (NIR)
            return compute_ndvi(
                nir.array[..., 1].astype(np.float64),
                nir.array[..., 0].astype(np.float64),
            ).astype(np.float32), nir.geotransform
        if red_path is None:
            raise ValueError(
                "--MOD09GQ_file_path is a single-band tif: pass the Red band "
                "via --red_file_path, a 2-band NIR/Red tif, or "
                "--ndvi_is_precomputed"
            )
        red = read_geotiff(red_path)
        return compute_ndvi(
            _single_band(nir, "the NIR input").astype(np.float64),
            _single_band(red, "the Red input").astype(np.float64),
        ).astype(np.float32), nir.geotransform
    from sifsr_tpu_torch.geo.hdf4 import read_modis_nir_red

    red, nir, gt = read_modis_nir_red(path)
    return compute_ndvi(nir, red).astype(np.float32), gt


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--MOD21A1D_file_path", type=str, required=True)
    parser.add_argument("--MOD09GQ_file_path", type=str, required=True)
    parser.add_argument("--red_file_path", type=str, default=None,
                        help="Red-band tif when MOD09GQ path is a NIR tif")
    parser.add_argument("--ndvi_is_precomputed", action="store_true")
    parser.add_argument("--time", default="day", choices=("day", "night"),
                        help="LST_Day_1km or LST_Night_1km when the input "
                             "is a MOD21A1 granule (reference predict.py is "
                             "day-only)")
    parser.add_argument("--model_dir", type=str, default="weights/modelB_1009")
    parser.add_argument("--model_name", type=str, default="modelB")
    parser.add_argument("--statistics", type=str, default="data/statistics.json")
    parser.add_argument("--save_path", type=str, default="./predictions")
    parser.add_argument("--batch_size", type=int, default=324)
    parser.add_argument("--overlap", type=int, default=0,
                        help="coarse-pixel tile overlap for seamless blending (0 = reference behaviour)")
    parser.add_argument("--device-tiling", action="store_true",
                        help="tile + mosaic on device (one upload/download; "
                             "fastest when the host<->device link is slow)")
    parser.add_argument("--mode", default=None,
                        choices=("host_pipeline", "device_tiling",
                                 "device_tiling_wire", "auto"),
                        help="granule serving mode; 'auto' probes the "
                             "host<->device link once and picks the mode "
                             "the measured regime favours (overrides "
                             "--device-tiling/--wire)")
    parser.add_argument("--f32", action="store_true", help="serve in float32 instead of bf16")
    parser.add_argument("--pad-impl", default=None,
                        choices=("fused", "explicit"),
                        help="conv padding implementation for the bf16/f32 "
                             "BN-folded path: 'fused' skips the materialised "
                             "replicate-pad copies (border ~1 ulp); default "
                             "'fused' in bf16 and 'explicit' with --f32, each "
                             "the faster on an H100; ignored by "
                             "--int8/--pallas (their kernels pad inside)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 quantized serving (models.quantized)")
    parser.add_argument("--pallas", action="store_true",
                        help="int8 serving with the hand-written fused kernels "
                             "(the fastest path; granule-self-calibrated like "
                             "--int8)")
    parser.add_argument("--up2-impl", default="mxu", choices=["mxu", "vpu"],
                        help="--pallas only: fused-x2 upsample factorization "
                             "('mxu' integer-exact row-mix, the default; "
                             "'vpu' bit-replays rasters made before it)")
    parser.add_argument("--calib-quantile", type=float, default=None,
                        help="int8/pallas: clip activation scales to this "
                             "|x|-quantile over the calibration blocks "
                             "instead of max-abs (default: max-abs, safe "
                             "for granules hotter/colder than the first)")
    parser.add_argument("--wire", default="f32", choices=("f32", "int"),
                        help="host<->device transfer format: 'int' ships "
                             "uint16 LST / int16 NDVI and a uint16 mosaic "
                             "(half the bytes; lossless for MODIS-native "
                             "data)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv)

    stats = Statistics.from_json(args.statistics)
    variables = load_variables(args.model_dir, args.model_name)

    try:
        lst, lst_gt = _load_lst(args.MOD21A1D_file_path, time=args.time)
        ndvi, ndvi_gt = _load_ndvi(args.MOD09GQ_file_path, args.red_file_path,
                                   args.ndvi_is_precomputed)
    except ValueError as exc:  # unusable input -> clean CLI error
        raise SystemExit(str(exc)) from exc
    print(f"LST {lst.shape}, NDVI {ndvi.shape}")

    common = dict(batch_size=args.batch_size, overlap=args.overlap,
                  device_tiling=args.device_tiling,
                  wire=None if args.wire == "f32" else args.wire, mode=args.mode,
                  device=args.device)
    if args.int8 or args.pallas:
        # quantize + calibrate on a sample of the granule's own valid blocks
        step, qparams = make_quantized_step(variables, lst, ndvi, stats, args.pallas,
                                            calib_quantile=args.calib_quantile,
                                            up2_impl=args.up2_impl, device=args.device)
        # coverage=0: quantized paths zero any block containing invalid
        # (0 K) pixels, as the inline loop always did
        mosaic = predict_granule(variables, lst, ndvi, stats, coverage=0.0, sr_step=step,
                                 step_params=qparams, **common)
    else:
        mosaic = predict_granule(
            variables, lst, ndvi, stats,
            compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
            pad_impl=args.pad_impl, **common)

    os.makedirs(args.save_path, exist_ok=True)
    out = os.path.join(args.save_path, "prediction.tiff")
    write_geotiff(out, mosaic.astype(np.float32), geotransform=ndvi_gt,
                  geo_ascii="MODIS Sinusoidal (sphere R=6371007.181)")
    print(f"wrote {out}  ({mosaic.shape[0]}x{mosaic.shape[1]})")


if __name__ == "__main__":
    main()
