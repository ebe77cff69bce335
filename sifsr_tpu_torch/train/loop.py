"""The training loop: epochs, on-device metric accumulation, early stopping,
epoch-granular checkpoint/resume.

Port of ``sifsr_tpu/train/loop.py``. Produces a metrics dict with the
reference's exact lossdata schema (train_model_B_predef_filters.py:320-330:
train_/val_ x loss/dsloss/perceploss/psnr/ssim lists + best_epoch) so
downstream tooling (plot_loss, read_losses) ports over unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import torch

from sifsr_tpu_torch.config import HATConfig, SwinIRConfig, TrainConfig
from sifsr_tpu_torch.data.datasets import (
    ArrayDataset,
    degrade_batch_scale_invariance,
    prepare_batch,
)
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.models.hat import HAT
from sifsr_tpu_torch.models.swinir import SwinIR
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.train.checkpoint import CheckpointManager
from sifsr_tpu_torch.train.early_stopping import EarlyStopping
from sifsr_tpu_torch.train.state import SifTrainState, create_train_state
from sifsr_tpu_torch.train.step import make_eval_step, make_train_step

__all__ = ["build_model", "train_loop"]

_METRIC_KEYS = {
    "predef_filters": ("loss", "ds_loss", "percep_loss", "psnr", "ssim"),
    "gradftm": ("loss", "ds_loss", "percep_loss", "psnr", "ssim"),
    "scale_invariance": ("loss", "psnr", "ssim"),
}
_REF_NAMES = {"loss": "loss", "ds_loss": "dsloss", "percep_loss": "perceploss", "psnr": "psnr", "ssim": "ssim"}


def _make_batch_prep(recipe: str, stats: Statistics, device: torch.device) -> Callable:
    if recipe == "scale_invariance":
        return functools.partial(
            degrade_batch_scale_invariance,
            mean_lst=stats.mean_lst,
            std_lst=stats.std_lst,
            device=device,
        )
    return functools.partial(prepare_batch, device=device)


def build_model(config: TrainConfig) -> torch.nn.Module:
    """The network ``config.model`` gives the widths of, at ``config``'s
    precision: SwinIR from a ``SwinIRConfig``, HAT from a ``HATConfig``,
    else ModelB_2. ``remat``, ``pad_impl='fused'`` and bf16 are ModelB_2's
    options: with SwinIR or HAT they raise ``ValueError``."""
    if config.precision not in ("highest", "default", "bf16"):
        raise ValueError(f"unknown precision {config.precision!r}")
    precision = "highest" if config.precision == "highest" else "default"
    if isinstance(config.model, (SwinIRConfig, HATConfig)):
        net = "SwinIR" if isinstance(config.model, SwinIRConfig) else "HAT"
        if config.remat:
            raise ValueError(f"remat (--remat) is a ModelB_2 option: {net} has no "
                             "block-by-block rematerialisation")
        if config.pad_impl != "explicit":
            raise ValueError(f"pad_impl {config.pad_impl!r} (--pad-impl) is a ModelB_2 "
                             f"option: {net}'s convs are zero-padded")
        if config.precision == "bf16":
            raise ValueError(f"precision 'bf16' is a ModelB_2 option: {net} trains in "
                             "float32 ('highest' or 'default')")
        widths = {k: tuple(v) if k in ("depths", "num_heads") else v
                  for k, v in dataclasses.asdict(config.model).items()}
        return (SwinIR if net == "SwinIR" else HAT)(**widths, precision=precision)
    return ModelB2(
        in_channels=config.model.in_channels,
        downchannels=tuple(config.model.downchannels),
        padding_mode=config.model.padding_mode,
        precision=precision,
        bilinear=config.model.bilinear,
        dtype=torch.bfloat16 if config.precision == "bf16" else torch.float32,
        pad_impl=config.pad_impl,
    )


def train_loop(
    config: TrainConfig,
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    model: torch.nn.Module | None = None,
    state: SifTrainState | None = None,
    checkpoint_dir: str | None = None,
    log_fn: Callable[[str], None] = print,
    device: str | torch.device = "cuda",
) -> tuple[SifTrainState, dict]:
    """Run the full training recipe on ``device``; returns (best-state,
    metrics dict).

    If ``checkpoint_dir`` is set, each epoch is persisted and an interrupted
    run resumes from the latest saved epoch automatically. Without ``model``
    or ``state`` the network is ``build_model(config)``; a fresh model is
    initialised from a generator seeded with ``config.seed``.
    """
    dev = resolve_device(device)
    hp = config.hyper
    stats = train_ds.stats

    if state is not None:
        model = state.model
    model = model or build_model(config)
    if state is None:
        state = create_train_state(
            model, hp.learning_rate,
            generator=torch.Generator().manual_seed(config.seed), device=dev,
        )

    train_step = make_train_step(
        model, config.recipe, hp.alpha, hp.gamma, stats.mean_lst, stats.std_lst,
        with_metrics=config.step_metrics, remat=config.remat,
    )
    eval_step = make_eval_step(
        model, config.recipe, hp.alpha, hp.gamma, stats.mean_lst, stats.std_lst,
        with_metrics=config.step_metrics,
    )
    batch_prep = _make_batch_prep(config.recipe, stats, dev)

    keys = _METRIC_KEYS[config.recipe]
    if not config.step_metrics:
        keys = tuple(k for k in keys if k not in ("psnr", "ssim"))
    metrics: dict = {f"{split}_{_REF_NAMES[k]}": [] for split in ("train", "val") for k in keys}
    stopper = EarlyStopping(hp.n_epochs, hp.patience)

    manager = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    start_epoch = 1
    if manager is not None and manager.latest_epoch() is not None:
        latest = manager.latest_epoch()
        state, extra, best = manager.restore_epoch(latest, state)
        metrics = extra["metrics"]
        stopper.curr_patience = extra["curr_patience"]
        stopper.saved_best_value = extra["saved_best_value"]
        stopper.best_epoch = extra["best_epoch"]
        stopper.saved_state = best
        start_epoch = latest + 1
        log_fn(f"resumed from epoch {latest}")

    best_variables = None
    for epoch in range(start_epoch, hp.n_epochs + 1):
        t0 = time.perf_counter()
        for split, ds in (("train", train_ds), ("val", val_ds)):
            acc = torch.zeros(len(keys), dtype=torch.float32, device=dev)
            n = 0
            # drop_remainder=False matches the reference DataLoader's default
            # drop_last=False (partial final batch included in the epoch means)
            for batch in ds.batches(
                hp.batch_size, seed=config.seed * 100003 + epoch, drop_remainder=False
            ):
                prepped = batch_prep(batch)
                if split == "train":
                    state, m = train_step(state, prepped)
                else:
                    m = eval_step(state, prepped)
                acc += torch.stack([m[k] for k in keys])
                n += 1
            # one host sync per epoch per split (the accumulators are scalars)
            acc = acc.cpu().tolist()
            for k, total in zip(keys, acc):
                metrics[f"{split}_{_REF_NAMES[k]}"].append(total / max(n, 1))

        val_loss = metrics["val_loss"][-1]
        stopper.update(epoch, val_loss, state.model.state_dict())
        extra = (
            f"psnr={metrics['val_psnr'][-1]:.2f}  ssim={metrics['val_ssim'][-1]:.3f}  "
            if config.step_metrics
            else ""
        )
        log_fn(
            f"epoch {epoch}/{hp.n_epochs}  train_loss={metrics['train_loss'][-1]:.5f}  "
            f"val_loss={val_loss:.5f}  {extra}({time.perf_counter() - t0:.1f}s)"
        )

        if manager is not None:
            manager.save_epoch(
                epoch,
                state,
                {
                    "metrics": metrics,
                    "curr_patience": stopper.curr_patience,
                    "saved_best_value": float(stopper.saved_best_value),
                    "best_epoch": stopper.best_epoch,
                },
                best_state=stopper.saved_state,
            )

        if stopper.should_stop:
            metrics["best_epoch"] = stopper.best_epoch
            best_variables = stopper.saved_state
            break
    else:
        metrics["best_epoch"] = metrics.get("best_epoch", hp.n_epochs)

    if best_variables is not None:
        state.model.load_state_dict(best_variables, strict=True)
    if manager is not None:
        manager.wait()
        manager.close()
    return state, metrics
