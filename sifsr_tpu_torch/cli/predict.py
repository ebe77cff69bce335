"""Weights and serving steps for whole-granule prediction.

Port of ``sifsr_tpu/cli/predict.py:33-95``: ``load_variables`` reads the
repository's weights, ``make_quantized_step`` builds the int8 serving step
calibrated on the granule itself (``predict --pallas``). The GeoTIFF/HDF
command line (``main``) waits for the ``geo/`` copies; see ROADMAP.md.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sifsr_tpu_torch.inference import tile_granule
from sifsr_tpu_torch.models.convert import from_jax_variables, load_msgpack_variables

__all__ = ["load_variables", "make_quantized_step"]


def load_variables(model_dir: str, model_name: str = "modelB") -> dict:
    """ModelB2 state dict from ``<model_dir>/<model_name>_variables.msgpack``
    (the flax tree), else from a reference ``<model_name>_state_dict.pt``
    (keys holding "factor", left by an older model revision, are dropped as
    the reference's predict.py:56-64 does)."""
    msgpack = os.path.join(model_dir, f"{model_name}_variables.msgpack")
    torch_sd = os.path.join(model_dir, f"{model_name}_state_dict.pt")
    if os.path.exists(msgpack):
        return from_jax_variables(load_msgpack_variables(msgpack))
    if os.path.exists(torch_sd):
        sd = torch.load(torch_sd, map_location="cpu", weights_only=True)
        return {k: v for k, v in sd.items() if "factor" not in k}
    raise FileNotFoundError(f"no weights under {model_dir}")


def make_quantized_step(variables, lst, ndvi, stats, use_pallas: bool,
                        calib_quantile: float | None = None,
                        device: str | torch.device = "cuda"):
    """Build the int8 serving step, statically calibrated on up to 8
    fully-valid 64x64 blocks of the given granule. Returns (step, params).

    use_pallas=True is the port's int8 step with its hand-written kernels
    (``models.int8_serving``, mid='xla'). The plain XLA int8 step of the JAX
    package (use_pallas=False) is not ported yet."""
    if not use_pallas:
        raise NotImplementedError(
            "the XLA int8 step (models/quantized.make_int8_sr_step) is not ported "
            "yet (ROADMAP.md); pass use_pallas=True")
    from sifsr_tpu_torch.models.int8_serving import (
        build_int8_serving_params,
        make_int8_sr_step,
    )

    lst_b, ndvi_b, _ = tile_granule(lst, np.clip(ndvi, -1, 1))
    valid = (lst_b != 0).all(axis=(1, 2))
    sel = np.nonzero(valid)[0][:8]
    if sel.size == 0:
        raise ValueError(
            "quantized serving needs at least one fully-valid 64x64 LST block to "
            "calibrate activation scales on; this granule has none (every block "
            "contains 0 K fill): serve it with the float step, or calibrate on a "
            "different granule first")
    params = build_int8_serving_params(variables, lst_b[sel], ndvi_b[sel], stats,
                                       calib_quantile=calib_quantile, device=device)
    return make_int8_sr_step(stats, device=device), params
