"""The scale-invariance-free training objectives.

Port of ``sifsr_tpu/losses/losses.py``. Three recipes (SURVEY.md §2 #14-16):

SIF-NN-SR1 (train_model_B_predef_filters.py:100-133):
    loss = α·Huber(renorm(downscale(unnorm(SR))), LST)
         + (1-α)·Huber(sobel_bank(SR), γ·sobel_bank(NDVI))

SIF-NN-SR2 (train_model_B_gradFTM.py:88-117):
    high-frequency residuals vs a PSF low-pass (mtf=0.25) instead of Sobel:
    loss = α·ds_loss + (1-α)·Huber(SR - lowpass(SR), γ·(NDVI - lowpass(NDVI)))

SC-Unet (train_model_B_scale_invariance.py:88-103):
    loss = Huber(SR, LST_1km)     (pure reconstruction at 64×64)

All functions take NHWC batches with a single channel and are differentiable
end to end; the PSF downscale and low-pass enter as precomputed per-axis
matrices (``ops.psf``), and on a CUDA tensor the ds-loss degradation runs
as the fused kernel of ``kernels/fused_ops.py``. Under a data-parallel
group (``mesh``, ``parallel.make_mesh``) each rank runs that kernel on its
own shard and ``ds_loss`` returns the global batch's loss, as the JAX
package's does with the kernel under ``shard_map``.
"""

from __future__ import annotations

import torch

from sifsr_tpu_torch.kernels.fused_ops import fused_psf_downscale
from sifsr_tpu_torch.ops.filters import directional_gradients
from sifsr_tpu_torch.ops.psf import downscale_lst_sr_to_lr, lowpass_ftm
from sifsr_tpu_torch.parallel.mesh import global_mean

__all__ = [
    "huber",
    "ds_loss",
    "percep_loss_predef",
    "percep_loss_gradftm",
    "sif_loss_predef",
    "sif_loss_gradftm",
    "scale_invariance_loss",
]


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """torch.nn.HuberLoss(reduction='mean', delta=1.0) parity."""
    err = pred - target
    abs_err = err.abs()
    quad = 0.5 * err * err
    lin = delta * (abs_err - 0.5 * delta)
    return torch.where(abs_err < delta, quad, lin).mean()


def _nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def ds_loss(
    sr: torch.Tensor,
    lst: torch.Tensor,
    mean_lst: float,
    std_lst: float,
    factor: int = 4,
    mtf: float = 0.1,
    use_pallas: bool | None = None,
    mesh=None,
    axis_name: str = "data",
) -> torch.Tensor:
    """Reconstruction loss: un-normalise the SR patch, degrade it through the
    sensor PSF model back to input resolution, re-normalise, Huber vs the
    input LST (train_model_B_predef_filters.py:110-118).

    ``use_pallas`` keeps the JAX package's name for "the fused kernel":
    None means the kernel for a CUDA tensor and the per-axis matmul chain
    for a CPU tensor; True goes through the kernel's wrapper (whose plain
    version runs on a CPU tensor); False is the matmul chain everywhere.

    ``mesh``: a ``parallel.Mesh``. ``sr`` and ``lst`` are this rank's shard
    of the global batch: the degradation is per image, so each rank runs it
    on its shard, and the returned loss is the global batch's (the mean of
    the ranks' losses over equal shards, through a differentiable
    all-reduce). ``axis_name`` is the mesh's one axis, kept for the JAX
    package's signature.
    """
    if use_pallas is None:
        use_pallas = sr.is_cuda
    if use_pallas:
        down = fused_psf_downscale(sr[..., 0], float(mean_lst), float(std_lst),
                                   factor=factor, mtf=mtf)[..., None]
        return global_mean(huber(down, lst), mesh)
    sr_unnorm = sr * std_lst + mean_lst
    down = downscale_lst_sr_to_lr(_nhwc_to_nchw(sr_unnorm), factor=factor, mtf=mtf)
    down = (down - mean_lst) / std_lst
    return global_mean(huber(_nchw_to_nhwc(down), lst), mesh)


def percep_loss_predef(sr: torch.Tensor, ndvi: torch.Tensor, gamma: float) -> torch.Tensor:
    """Sobel-bank perceptual loss (train_model_B_predef_filters.py:120-130);
    γ < 0 encodes the LST/NDVI anticorrelation."""
    return huber(directional_gradients(sr), gamma * directional_gradients(ndvi))


def percep_loss_gradftm(
    sr: torch.Tensor, ndvi: torch.Tensor, gamma: float, mtf: float = 0.25
) -> torch.Tensor:
    """Gradient-FTM perceptual loss (train_model_B_gradFTM.py:108-114):
    high frequencies = x - PSF-lowpass(x, mtf)."""
    hf_sr = sr - _nchw_to_nhwc(lowpass_ftm(_nhwc_to_nchw(sr), mtf=mtf))
    hf_ndvi = ndvi - _nchw_to_nhwc(lowpass_ftm(_nhwc_to_nchw(ndvi), mtf=mtf))
    return huber(hf_sr, gamma * hf_ndvi)


def sif_loss_predef(
    sr: torch.Tensor,
    lst: torch.Tensor,
    ndvi: torch.Tensor,
    alpha: float,
    gamma: float,
    mean_lst: float,
    std_lst: float,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    dsl = ds_loss(sr, lst, mean_lst, std_lst, mesh=mesh)
    pl = percep_loss_predef(sr, ndvi, gamma)
    total = alpha * dsl + (1.0 - alpha) * pl
    return total, {"ds_loss": dsl, "percep_loss": pl}


def sif_loss_gradftm(
    sr: torch.Tensor,
    lst: torch.Tensor,
    ndvi: torch.Tensor,
    alpha: float,
    gamma: float,
    mean_lst: float,
    std_lst: float,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    dsl = ds_loss(sr, lst, mean_lst, std_lst, mesh=mesh)
    pl = percep_loss_gradftm(sr, ndvi, gamma)
    total = alpha * dsl + (1.0 - alpha) * pl
    return total, {"ds_loss": dsl, "percep_loss": pl}


def scale_invariance_loss(sr: torch.Tensor, lst_1km: torch.Tensor) -> tuple[torch.Tensor, dict]:
    total = huber(sr, lst_1km)
    return total, {}
