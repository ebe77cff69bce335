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

- gssim:  the reference's modified SSIM (utils.py:1904-2005): luminance from
          the raw images, contrast/structure from Sobel gradient magnitudes
          computed with scipy.signal.convolve2d(mode='valid'), a true
          convolution, so the Sobel kernels enter flipped.
- rmse / stratified rmse / gradient rmse: model_perf_aster_formatds.py:371-438.

The convolutions run in full float32 (``device.full_f32``), as the JAX
package's run at ``Precision.HIGHEST``. The numpy forms at the end
(``ssim_np``, ``psnr_np``, ``gssim_np``) are what the evaluation harness
uses on its variable-shape crops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sifsr_tpu_torch.device import full_f32
from sifsr_tpu_torch.ops.quantile import quantile_linear

__all__ = ["psnr", "psnr_batch_mean", "ssim", "ssim_batch_mean", "gssim", "rmse",
           "gradient_rmse", "stratified_rmse", "ssim_np", "psnr_np", "gssim_np"]


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: torch.Tensor) -> torch.Tensor:
    """PSNR in dB of one image pair (any matching shape)."""
    mse = torch.mean(torch.square(target - pred))
    return 10.0 * torch.log10(torch.square(data_range) / mse)


def psnr_batch_mean(pred: torch.Tensor, target: torch.Tensor,
                    data_range: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per-image PSNR over an (N, H, W) batch with the reference's
    batch-wide data_range convention (utils.py:548-552); a data-parallel
    step passes the global batch's range."""
    if data_range is None:
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


def ssim_batch_mean(pred: torch.Tensor, target: torch.Tensor,
                    data_range: torch.Tensor | None = None) -> torch.Tensor:
    """Mean SSIM over an (N, H, W) batch, batch-wide data_range
    (utils.py:554-578; a data-parallel step passes the global batch's)."""
    if data_range is None:
        data_range = target.max() - target.min()
    return ssim(pred, target, data_range).mean()


# --------------------------------------------------------------------------- GSSIM
_SOBEL_X = np.asarray([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)


def _conv2d_valid_true(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """scipy.signal.convolve2d(mode='valid') on (N, H, W): true convolution,
    i.e. cross-correlation with the 180°-flipped kernel, in full float32."""
    k = torch.as_tensor(np.ascontiguousarray(kernel[::-1, ::-1]), dtype=x.dtype,
                        device=x.device)[None, None]
    with full_f32():
        return F.conv2d(x[:, None], k)[:, 0]


def gssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: torch.Tensor,
    win_size: int = 7,
) -> torch.Tensor:
    """Gradient SSIM (reference utils.py:1904-2005) on (N, H, W) -> (N,).

    L from raw images, C and S from Sobel gradient magnitudes; the reference's
    explicit L*C*S decomposition (utils.py:1994-1998) is reproduced, including
    its asymmetric S denominator constant C2/2.
    """
    im1 = target.to(torch.float32)
    im2 = pred.to(torch.float32)

    f0 = _conv2d_valid_true(im1, _SOBEL_X)
    f1 = _conv2d_valid_true(im1, _SOBEL_X.T)
    g0 = _conv2d_valid_true(im2, _SOBEL_X)
    g1 = _conv2d_valid_true(im2, _SOBEL_X.T)
    f_mag = torch.sqrt(f0 * f0 + f1 * f1)
    g_mag = torch.sqrt(g0 * g0 + g1 * g1)

    im1 = im1[:, 1:-1, 1:-1]
    im2 = im2[:, 1:-1, 1:-1]

    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)

    with full_f32():
        ux = _valid_window_mean(im1, win_size)
        uy = _valid_window_mean(im2, win_size)
        uf = _valid_window_mean(f_mag, win_size)
        ug = _valid_window_mean(g_mag, win_size)
        vx = cov_norm * (_valid_window_mean(f_mag * f_mag, win_size) - uf * uf)
        vy = cov_norm * (_valid_window_mean(g_mag * g_mag, win_size) - ug * ug)
        vxy = cov_norm * (_valid_window_mean(f_mag * g_mag, win_size) - uf * ug)

    c1 = torch.square(0.01 * torch.as_tensor(data_range, dtype=torch.float32))
    c2 = torch.square(0.03 * torch.as_tensor(data_range, dtype=torch.float32))

    lum = (2 * ux * uy + c1) / (ux * ux + uy * uy + c1)
    con = (2 * torch.sqrt(vx) * torch.sqrt(vy) + c2) / (vx + vy + c2)
    struct = (vxy + c2) / (torch.sqrt(vx) * torch.sqrt(vy) + c2 / 2)
    return (lum * con * struct).mean(dim=(-2, -1))


# --------------------------------------------------------------------------- RMSE family
def rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(pred - target), dim=(-2, -1)))


def gradient_rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """RMSE between Sobel gradient magnitudes (valid region), per image
    (model_perf_aster_formatds.py:426-438 semantics)."""
    f_mag = torch.sqrt(torch.square(_conv2d_valid_true(target, _SOBEL_X))
                       + torch.square(_conv2d_valid_true(target, _SOBEL_X.T)))
    g_mag = torch.sqrt(torch.square(_conv2d_valid_true(pred, _SOBEL_X))
                       + torch.square(_conv2d_valid_true(pred, _SOBEL_X.T)))
    return rmse(g_mag, f_mag)


def stratified_rmse(
    pred: torch.Tensor,
    target: torch.Tensor,
    strata_field: torch.Tensor,
    q_low: float = 0.25,
    q_high: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSE stratified by quartiles of a per-pixel field (the reference uses
    the ASTER high-frequency gradient magnitude). Returns (low, mid, high)
    per-image RMSEs over the masked pixels."""
    flat = strata_field.reshape(*strata_field.shape[:-2], -1)
    lo = quantile_linear(flat, q_low)[..., None, None]
    hi = quantile_linear(flat, q_high)[..., None, None]
    sq = torch.square(pred - target)

    def masked_rmse(mask):
        total = torch.sum(sq * mask, dim=(-2, -1))
        count = torch.sum(mask, dim=(-2, -1)).to(sq.dtype)
        return torch.sqrt(total / torch.clamp_min(count, 1))

    return (
        masked_rmse(strata_field < lo),
        masked_rmse((strata_field >= lo) & (strata_field <= hi)),
        masked_rmse(strata_field > hi),
    )


# ----------------------------------------------------------------- numpy paths
# The ASTER harness produces variable-shape crops on the host; these numpy
# forms share the semantics above and are what eval.harness uses per pair.
def ssim_np(pred, target, data_range: float, win_size: int = 7) -> float:
    from scipy.ndimage import uniform_filter

    x = target.astype(np.float64)
    y = pred.astype(np.float64)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)

    def f(im):
        return uniform_filter(im, size=win_size)

    ux, uy = f(x), f(y)
    vx = cov_norm * (f(x * x) - ux * ux)
    vy = cov_norm * (f(y * y) - uy * uy)
    vxy = cov_norm * (f(x * y) - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def psnr_np(pred, target, data_range: float) -> float:
    mse = float(np.mean((target.astype(np.float64) - pred.astype(np.float64)) ** 2))
    return 10.0 * float(np.log10(data_range**2 / mse))


def gssim_np(pred, target, data_range: float, win_size: int = 7) -> float:
    import scipy.signal as sps
    from scipy.ndimage import uniform_filter

    im1 = target.astype(np.float64)
    im2 = pred.astype(np.float64)
    kx = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    ky = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
    f0 = sps.convolve2d(im1, kx, mode="valid")
    f1 = sps.convolve2d(im1, ky, mode="valid")
    g0 = sps.convolve2d(im2, kx, mode="valid")
    g1 = sps.convolve2d(im2, ky, mode="valid")
    f_mag = np.sqrt(f0**2 + f1**2)
    g_mag = np.sqrt(g0**2 + g1**2)
    im1, im2 = im1[1:-1, 1:-1], im2[1:-1, 1:-1]
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)

    def f(im):
        return uniform_filter(im, size=win_size)

    ux, uy = f(im1), f(im2)
    vx = cov_norm * (f(f_mag * f_mag) - f(f_mag) ** 2)
    vy = cov_norm * (f(g_mag * g_mag) - f(g_mag) ** 2)
    vxy = cov_norm * (f(f_mag * g_mag) - f(f_mag) * f(g_mag))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    lum = (2 * ux * uy + c1) / (ux**2 + uy**2 + c1)
    con = (2 * np.sqrt(vx) * np.sqrt(vy) + c2) / (vx + vy + c2)
    struct = (vxy + c2) / (np.sqrt(vx) * np.sqrt(vy) + c2 / 2)
    pad = (win_size - 1) // 2
    return float((lum * con * struct)[pad:-pad, pad:-pad].mean())
