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

__all__ = ["DatasetConfig", "ModelConfig", "HyperParams", "SaveConfig", "TrainConfig", "load_params_json"]


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
    model: ModelConfig = ModelConfig()
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
    """
    with open(path) as f:
        data = json.load(f)
    ds = data.get("dataset_parameter", {})
    hp = data.get("hyperparameters", {})
    mp = data.get("modelB_parameters", {})
    sp = data.get("save_parameters", {})
    return TrainConfig(
        dataset=DatasetConfig(
            time=ds.get("time", "day"),
            transf=ds.get("transf", "norm"),
        ),
        model=ModelConfig(
            in_channels=mp.get("in_channels", 2),
            downchannels=tuple(mp.get("downchannels", (16, 32, 64, 128))),
            padding_mode=mp.get("padding_mode", "replicate"),
            activation=mp.get("activation", "ReLU"),
            bilinear=bool(mp.get("bilinear", True)),
            n_bridge_blocks=mp.get("n_bridge_blocks", 1),
        ),
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
