"""One train/eval step per recipe: forward + sensor-model degradation + both
loss terms + backward + Adam + on-device metrics.

Port of ``sifsr_tpu/train/step.py``. Metrics come back as 0-d tensors on the
device; nothing in a step synchronises with the host.

Batch convention (all NHWC, single channel):
  recipe 'predef_filters' / 'gradftm':
      {'lst': (N,64,64,1), 'lst_up': (N,256,256,1), 'ndvi': (N,256,256,1)}
  recipe 'scale_invariance':
      {'lst_up': (N,64,64,1) [=4km bicubic-up], 'ndvi': (N,64,64,1) [=1km],
       'lst': (N,64,64,1) [=1km target]}
  (the scale-invariance recipe reuses the same keys: lst is always the
   reconstruction target, lst_up always the first model input channel.)

Train-time PSNR/SSIM follow the reference's convention of scoring SR against
the *bicubic input* (there is no HR ground truth; train_model_B_*.py:142-143);
for scale_invariance they score against the 1 km target like the reference
(train_model_B_scale_invariance.py:106-107).

Precision: under ``model.precision == 'highest'`` each step runs its forward,
losses, metrics and backward with TF32 off for cuDNN and matmul
(``device.full_f32``: the model's convs, the Sobel bank and SSIM's window
means are cuDNN convolutions, the PSF low-pass a matmul). 'default' leaves
the process's ``torch.backends`` flags alone, so cuDNN may use TF32.

Data parallelism (``mesh``, a ``parallel.Mesh``): each rank's step takes its
shard of the global batch, and the step does what the JAX package's
partitioner does, so that it is the single-device step on the global batch:
the model's BatchNorms take the global moments (``parallel.convert_batchnorm``,
in place), ``ds_loss`` is the global batch's (kernel M on each shard), the
gradients are averaged over the ranks before Adam, and the metrics too.
"""

from __future__ import annotations

import torch

from sifsr_tpu_torch import tracing
from sifsr_tpu_torch.device import full_f32
from sifsr_tpu_torch.eval.metrics import psnr_batch_mean, ssim_batch_mean
from sifsr_tpu_torch.losses.losses import (
    scale_invariance_loss,
    sif_loss_gradftm,
    sif_loss_predef,
)
from sifsr_tpu_torch.parallel.mesh import average_tensors, convert_batchnorm, global_range
from sifsr_tpu_torch.train.state import SifTrainState

__all__ = ["make_train_step", "make_eval_step", "RECIPES"]

RECIPES = ("predef_filters", "gradftm", "scale_invariance")


def _loss_and_aux(recipe, sr, batch, alpha, gamma, mean_lst, std_lst, mesh=None):
    if recipe == "predef_filters":
        return sif_loss_predef(sr, batch["lst"], batch["ndvi"], alpha, gamma,
                               mean_lst, std_lst, mesh=mesh)
    if recipe == "gradftm":
        return sif_loss_gradftm(sr, batch["lst"], batch["ndvi"], alpha, gamma,
                                mean_lst, std_lst, mesh=mesh)
    if recipe == "scale_invariance":
        return scale_invariance_loss(sr, batch["lst"])
    raise ValueError(f"unknown recipe {recipe!r}; expected one of {RECIPES}")


def _metric_target(recipe, batch):
    # reference scores vs bicubic input (SR1/SR2) or the 1 km target (SC-Unet)
    return batch["lst"] if recipe == "scale_invariance" else batch["lst_up"]


def _step_metrics(recipe, total, parts, sr, batch, with_metrics, mesh=None):
    metrics = {"loss": total.detach(), **{k: v.detach() for k, v in parts.items()}}
    if with_metrics:
        with torch.no_grad():
            target = _metric_target(recipe, batch)[..., 0]
            # the reference's data range is the batch's: under a mesh, the
            # global batch's
            data_range = None if mesh is None else global_range(target, mesh)
            metrics["psnr"] = psnr_batch_mean(sr.detach()[..., 0], target, data_range)
            metrics["ssim"] = ssim_batch_mean(sr.detach()[..., 0], target, data_range)
    if mesh is not None:
        # batch means over equal shards: their mean is the global batch's
        metrics = {k: v.clone() for k, v in metrics.items()}
        average_tensors(list(metrics.values()), mesh)
    return metrics


def make_train_step(
    model: torch.nn.Module,
    recipe: str,
    alpha: float,
    gamma: float,
    mean_lst: float,
    std_lst: float,
    with_metrics: bool = True,
    mesh=None,
    remat: bool = False,
):
    """Build the train step: (state, batch) -> (state, metrics dict). The
    state's model (``models.unet.ModelB2``, ``models.swinir.SwinIR`` or
    ``models.hat.HAT``: NHWC (N, H, W, 2) in, (N, H, W, 1) out) and optimiser
    are updated in place; ``batch`` holds tensors on the model's device.

    ``mesh``: the data-parallel group (module docstring); ``batch`` is then
    this rank's shard (``parallel.shard_batch``, or the global batch through
    ``parallel.make_parallel_train_step``), and ``model``'s BatchNorms are
    converted to the group's in place.

    Under ``tracing`` each call is a ``train_step`` root: the host's time
    to enqueue the forward, the losses, the backward, Adam and the metrics.

    ``remat`` (ModelB_2 only): the model rematerialises block by block
    (``ModelB2.forward(x, remat=True)``): only the blocks' inputs are held
    across the backward pass, at about one extra forward and the same
    numerics. The recomputation would update the BatchNorm running
    statistics a second time, so they are restored to their values after the
    first forward."""
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}; expected one of {RECIPES}")
    exact = model.precision == "highest"
    if mesh is not None:
        convert_batchnorm(model, mesh)

    @tracing.rooted("train_step")
    def train_step(state: SifTrainState, batch: dict):
        model.train()
        with full_f32(exact):
            state.optimizer.zero_grad(set_to_none=True)
            sr = model(torch.cat([batch["lst_up"], batch["ndvi"]], dim=-1), remat=remat)
            total, parts = _loss_and_aux(recipe, sr, batch, alpha, gamma, mean_lst, std_lst,
                                         mesh)
            if remat:
                buffers = [(b, b.clone()) for b in model.buffers()]
            total.backward()
            if remat:
                with torch.no_grad():
                    for b, saved in buffers:
                        b.copy_(saved)
            if mesh is not None:
                average_tensors([p.grad for p in model.parameters() if p.grad is not None],
                                mesh)
            state.optimizer.step()
            state.step += 1
            return state, _step_metrics(recipe, total, parts, sr, batch, with_metrics, mesh)

    train_step.mesh = mesh
    return train_step


def make_eval_step(
    model: torch.nn.Module,
    recipe: str,
    alpha: float,
    gamma: float,
    mean_lst: float,
    std_lst: float,
    with_metrics: bool = True,
    mesh=None,
):
    """Build the eval step: (state, batch) -> metrics dict (the model in
    eval mode, ModelB_2's BatchNorm on its running statistics; no
    gradient). ``mesh``: ``batch`` is this rank's shard, and the metrics are
    the global batch's."""
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}; expected one of {RECIPES}")
    exact = model.precision == "highest"

    @torch.no_grad()
    def eval_step(state: SifTrainState, batch: dict):
        model.eval()
        with full_f32(exact):
            sr = model(torch.cat([batch["lst_up"], batch["ndvi"]], dim=-1))
            total, parts = _loss_and_aux(recipe, sr, batch, alpha, gamma, mean_lst, std_lst,
                                         mesh)
            return _step_metrics(recipe, total, parts, sr, batch, with_metrics, mesh)

    return eval_step
