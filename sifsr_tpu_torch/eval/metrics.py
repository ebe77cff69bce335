"""Image-quality metrics as batch ops on the device (skimage-compatible).

Port of ``sifsr_tpu/eval/metrics.py:41-101``: the PSNR and SSIM that the
train and eval steps report per batch. The reference computes them on the
host with skimage (utils.py:548-578), a device->host sync every training
step; here they are functions of (N, H, W) tensors that return device
tensors and never synchronise:

- psnr:   skimage.metrics.peak_signal_noise_ratio with the *batch-wide*
          data_range = targets.max() - targets.min() (utils.py:551).
- ssim:   skimage.metrics.structural_similarity defaults: 7x7 uniform window,
          sample covariance (cov_norm = NP/(NP-1)), K1=0.01, K2=0.03,
          gaussian_weights=False, border crop of (win-1)//2. A reflect-padded
          uniform filter cropped by the window radius equals a VALID window
          mean, so only VALID means are computed (no pad at all).

The rest of the JAX module (gssim, rmse and its variants) comes with the
evaluation harness (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["psnr", "psnr_batch_mean", "ssim", "ssim_batch_mean"]


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: torch.Tensor) -> torch.Tensor:
    """PSNR in dB of one image pair (any matching shape)."""
    mse = torch.mean(torch.square(target - pred))
    return 10.0 * torch.log10(torch.square(data_range) / mse)


def psnr_batch_mean(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-image PSNR over an (N, H, W) batch with the reference's
    batch-wide data_range convention (utils.py:548-552)."""
    data_range = target.max() - target.min()
    mse = torch.mean(torch.square(target - pred), dim=(-2, -1))
    return torch.mean(10.0 * torch.log10(torch.square(data_range) / mse))


def _valid_window_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """VALID uniform-window mean over the trailing 2 axes of (N, H, W)."""
    kernel = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)
    return F.conv2d(x[:, None], kernel)[:, 0]


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: torch.Tensor,
    win_size: int = 7,
) -> torch.Tensor:
    """skimage-default SSIM of an (N, H, W) batch -> (N,) scores."""
    x = target.to(torch.float32)
    y = pred.to(torch.float32)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)

    ux = _valid_window_mean(x, win_size)
    uy = _valid_window_mean(y, win_size)
    uxx = _valid_window_mean(x * x, win_size)
    uyy = _valid_window_mean(y * y, win_size)
    uxy = _valid_window_mean(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = torch.square(0.01 * data_range)
    c2 = torch.square(0.03 * data_range)
    ssim_map = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return ssim_map.mean(dim=(-2, -1))


def ssim_batch_mean(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over an (N, H, W) batch, batch-wide data_range
    (utils.py:554-578)."""
    data_range = target.max() - target.min()
    return ssim(pred, target, data_range).mean()
