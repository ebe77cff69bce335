"""Training CLI: covers all three reference training scripts
(train_model_B_predef_filters.py / _gradFTM.py / _scale_invariance.py) with
one entry point parameterised by --recipe.

    python -m sifsr_tpu_torch.cli.train --params ./paramsB.json --recipe predef_filters

Port of ``sifsr_tpu/cli/train.py``, same flags plus ``--device``. Behaviour
mirrors the reference __main__ (train_model_B_predef_filters.py:442-514):
loads the params JSON, refuses to overwrite an existing save dir, trains with
early stopping, saves weights + params copy + metrics pickle + loss/psnr/ssim
curve PNGs. --resume picks up from the latest epoch checkpoint under
``<save_path>/checkpoints``. --streaming decodes each batch on demand through
the native thread pool (``StreamingModisDataset``); --pad-impl fused trains
with the zero-padded convs plus border corrections of ``models.unet``.

A params file with ``"model": "SwinIR"`` and a ``swinir_parameters`` section
(``paramsSwinIR.json``: SwinIR-M x4), or with ``"model": "HAT"`` and a
``hat_parameters`` section (``paramsHAT.json``: HAT x4), trains that network
through the same loop, steps, recipes and checkpoints; --remat and
--pad-impl fused are ModelB_2 options and raise ``ValueError`` there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from argparse import ArgumentParser

from sifsr_tpu_torch.config import load_params_json
from sifsr_tpu_torch.data.datasets import ModisDataset, StreamingModisDataset
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.train.checkpoint import save_final
from sifsr_tpu_torch.train.loop import build_model, train_loop
from sifsr_tpu_torch.train.step import RECIPES

__all__ = ["main", "plot_loss"]


def plot_loss(metrics: dict, save_path: str, model_name: str) -> None:
    """Loss/PSNR/SSIM(/dsloss/perceploss) curve PNGs
    (reference train_model_B_predef_filters.py:378-439 outputs)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = {
        "loss": ("train_loss", "val_loss"),
        "psnr": ("train_psnr", "val_psnr"),
        "ssim": ("train_ssim", "val_ssim"),
        "dsloss": ("train_dsloss", "val_dsloss"),
        "perceploss": ("train_perceploss", "val_perceploss"),
    }
    for suffix, (tr, va) in curves.items():
        if tr not in metrics:
            continue
        plt.figure(figsize=(10, 7))
        plt.plot(metrics[tr], label=f"Train {suffix}")
        plt.plot(metrics[va], label=f"Val {suffix}")
        plt.legend(loc="upper right")
        plt.xlabel("epoch")
        plt.ylabel(suffix)
        plt.title(f"{suffix} = f(epoch)")
        plt.savefig(os.path.join(save_path, f"{model_name}_{suffix}.png"))
        plt.close()


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--params", type=str, default="./paramsB.json")
    parser.add_argument("--recipe", type=str, default="predef_filters", choices=RECIPES)
    parser.add_argument("--resume", action="store_true", help="resume from epoch checkpoints")
    parser.add_argument("--statistics", type=str, default="data/statistics.json")
    parser.add_argument("--csv", type=str, default="data/ModisDatasetB.csv")
    parser.add_argument("--streaming", action="store_true",
                        help="decode batches on demand through the native thread pool "
                             "with prefetch (for corpora larger than host RAM) instead "
                             "of materialising the dataset up front")
    parser.add_argument("--pad-impl", type=str, default="explicit",
                        choices=["explicit", "fused"],
                        help="conv padding implementation: 'fused' is a zero-padded conv "
                             "plus border-ring corrections, without the padded copy of "
                             "each conv input (border pixels differ from 'explicit' by "
                             "float summation order)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialise the model block by block in the backward "
                             "pass (torch.utils.checkpoint): same numerics, about one "
                             "extra forward, lower activation memory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu' (the "
                             "kernels' plain PyTorch versions)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)

    config = load_params_json(args.params, recipe=args.recipe)
    if args.remat:
        config = dataclasses.replace(config, remat=True)
    if args.pad_impl != "explicit":
        config = dataclasses.replace(config, pad_impl=args.pad_impl)
    model = build_model(config)
    stats = Statistics.from_json(args.statistics)

    save_path = config.save.save_path
    if os.path.isdir(save_path) and not args.resume:
        print("The model chosen already exists.")
        print("Stopping the training.")
        sys.exit(0)

    print("Loading the ModisDataset...")
    ds_cls = StreamingModisDataset if args.streaming else ModisDataset
    train_ds = ds_cls(args.csv, stats, split="Train",
                      time=config.dataset.time, transf=config.dataset.transf)
    val_ds = ds_cls(args.csv, stats, split="Val",
                    time=config.dataset.time, transf=config.dataset.transf)
    print(f"train={len(train_ds)} val={len(val_ds)}")

    ckpt_dir = os.path.join(save_path, "checkpoints") if args.resume else None
    state, metrics = train_loop(config, train_ds, val_ds, model=model,
                                checkpoint_dir=ckpt_dir, device=device)

    os.makedirs(save_path, exist_ok=True)
    with open(args.params) as f:
        params_json = json.load(f)
    save_final(save_path, config.save.model_name, state, metrics, params_json)
    plot_loss(metrics, save_path, config.save.model_name)
    print(f"saved to {save_path} (best epoch {metrics.get('best_epoch')})")


if __name__ == "__main__":
    main()
