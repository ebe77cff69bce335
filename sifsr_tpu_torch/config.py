"""Typed configuration, unifying the reference's params JSON + script globals.

The port's own copy of ``sifsr_tpu/config.py`` (same fields, same loader).

The reference configures training through paramsB.json (read by
utils.read_JsonB, utils.py:741-764) and evaluation through module-level
variables edited in place (model_perf_aster_formatds.py:65-80). Here a single
frozen dataclass tree covers both, with a loader that accepts the reference's
exact JSON schema so existing param files keep working.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Sequence

__all__ = ["DatasetConfig", "ModelConfig", "SwinIRConfig", "HATConfig", "HyperParams",
           "SaveConfig", "TrainConfig", "NETWORKS", "load_params_json"]

NETWORKS = ("ModelB_2", "SwinIR", "HAT")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    time: str = "day"            # 'day' | 'night' | 'Both'
    transf: str = "norm"         # 'norm' | '0-1' | '-1_1'
    csv_path: str = "data/ModisDatasetB.csv"
    statistics_path: str = "data/statistics.json"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    in_channels: int = 2
    downchannels: Sequence[int] = (16, 32, 64, 128)
    padding_mode: str = "replicate"
    activation: str = "ReLU"
    bilinear: bool = True
    n_bridge_blocks: int = 1     # accepted for JSON compat; unused (like the reference)


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    """SwinIR's widths (``models.swinir``), named as ``network_swinir.py``'s
    arguments; the defaults are SwinIR-M x4 (classical SR), with ``in_chans``
    the 2 guide channels' 4x4 sub-pixels."""
    upscale: int = 4
    in_chans: int = 32
    embed_dim: int = 180
    depths: Sequence[int] = (6, 6, 6, 6, 6, 6)
    num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    num_feat: int = 64


@dataclasses.dataclass(frozen=True)
class HATConfig:
    """HAT's widths (``models.hat``), named as ``hat_arch.py``'s arguments;
    the defaults are HAT x4 (classical SR, ``HAT_SRx4``), with ``in_chans``
    the 2 guide channels' 4x4 sub-pixels."""
    upscale: int = 4
    in_chans: int = 32
    embed_dim: int = 180
    depths: Sequence[int] = (6, 6, 6, 6, 6, 6)
    num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6)
    window_size: int = 16
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    overlap_ratio: float = 0.5
    mlp_ratio: float = 2.0
    num_feat: int = 64


# the choices of network_swinir.py and hat_arch.py that models.swinir and
# models.hat implement and no other
_SWIN_FIXED = {"upsampler": "pixelshuffle", "resi_connection": "1conv", "qkv_bias": True,
               "patch_norm": True, "ape": False, "img_range": 1.0, "drop_path_rate": 0.0,
               "num_out_ch": 1}
# each transformer's section of the params file and its widths
_TRANSFORMERS = {"SwinIR": ("swinir_parameters", SwinIRConfig),
                 "HAT": ("hat_parameters", HATConfig)}


@dataclasses.dataclass(frozen=True)
class HyperParams:
    batch_size: int = 8
    learning_rate: float = 1e-3
    n_epochs: int = 200
    patience: int = 30
    alpha: float = 0.1
    gamma: float = -0.4


@dataclasses.dataclass(frozen=True)
class SaveConfig:
    model_name: str = "modelB"
    save_path: str = "./models/modelB_test"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dataset: DatasetConfig = DatasetConfig()
    # the network trained, by the type of its widths: ModelB_2, SwinIR or HAT
    model: ModelConfig | SwinIRConfig | HATConfig = ModelConfig()
    hyper: HyperParams = HyperParams()
    save: SaveConfig = SaveConfig()
    recipe: str = "predef_filters"  # 'predef_filters' | 'gradftm' | 'scale_invariance'
    seed: int = 0
    # data-parallel replicas (0 = all), as in the JAX package, whose
    # train_loop does not read it either: a data-parallel run builds its
    # group with parallel.make_mesh(n_devices) and passes it to the steps
    n_devices: int = 0
    # conv/matmul precision: 'highest' = full float32 (TF32 off for cuDNN and
    # matmul, torch-reference parity); 'default' = whatever the process's
    # torch.backends flags allow (cuDNN convs default to TF32 on Hopper);
    # 'bf16' = mixed precision (bf16 activations under autocast, float32
    # master weights, float32 BatchNorm statistics, float32 Adam)
    precision: str = "highest"
    # per-step on-device PSNR/SSIM (the reference computes them per batch)
    step_metrics: bool = True
    # conv padding implementation: 'explicit' = the replicate-padded conv
    # (reference parity); 'fused' = a zero-padded conv plus border-ring
    # corrections, without the padded copy of each conv input (border pixels
    # differ by float summation order; models.unet.replicate_conv_fused)
    pad_impl: str = "explicit"
    # rematerialise the model block by block in the backward pass
    # (torch.utils.checkpoint): only the blocks' inputs are held across it,
    # at the cost of about one extra forward. Same numerics.
    remat: bool = False


def load_params_json(path: str, recipe: str = "predef_filters") -> TrainConfig:
    """Load a reference-format paramsB.json into a TrainConfig.

    Field names/sections follow the reference schema exactly
    (paramsB.json / SURVEY.md §2 #19); unknown sections (modelA_parameters,
    device) are ignored: the entry points take an explicit ``device``.
    A top-level ``"model": "SwinIR"`` trains SwinIR: ``model`` is then a
    ``SwinIRConfig`` from the ``swinir_parameters`` section
    (``paramsSwinIR.json``); ``"model": "HAT"`` trains HAT, a ``HATConfig``
    from the ``hat_parameters`` section (``paramsHAT.json``); without either
    the network is ModelB_2.
    """
    with open(path) as f:
        data = json.load(f)
    network = data.get("model", "ModelB_2")
    if network not in NETWORKS:
        raise ValueError(f"{path}: unknown model {network!r}; expected one of {NETWORKS}")
    ds = data.get("dataset_parameter", {})
    hp = data.get("hyperparameters", {})
    mp = data.get("modelB_parameters", {})
    sp = data.get("save_parameters", {})
    if network in _TRANSFORMERS:
        section, widths = _TRANSFORMERS[network]
        sw = data.get(section, {})
        for key, value in _SWIN_FIXED.items():
            if key in sw and sw[key] != value:
                raise ValueError(f"{path}: {section}.{key} is {sw[key]!r}; the port "
                                 f"implements {value!r} only")
        model = widths(**{
            f.name: tuple(sw[f.name]) if f.name in ("depths", "num_heads") else sw[f.name]
            for f in dataclasses.fields(widths) if f.name in sw})
    else:
        model = ModelConfig(
            in_channels=mp.get("in_channels", 2),
            downchannels=tuple(mp.get("downchannels", (16, 32, 64, 128))),
            padding_mode=mp.get("padding_mode", "replicate"),
            activation=mp.get("activation", "ReLU"),
            bilinear=bool(mp.get("bilinear", True)),
            n_bridge_blocks=mp.get("n_bridge_blocks", 1),
        )
    return TrainConfig(
        dataset=DatasetConfig(
            time=ds.get("time", "day"),
            transf=ds.get("transf", "norm"),
        ),
        model=model,
        hyper=HyperParams(
            batch_size=hp.get("batch_size", 8),
            learning_rate=hp.get("learning_rate", 1e-3),
            n_epochs=hp.get("n_epochs", 200),
            patience=hp.get("patience", 30),
            alpha=hp.get("alpha", 0.1),
            gamma=hp.get("gamma", -0.4),
        ),
        save=SaveConfig(
            model_name=sp.get("model_name", "modelB"),
            save_path=sp.get("save_path", "./models/modelB_test"),
        ),
        recipe=recipe,
    )
