"""Gaussian PSF/MTF sensor model, collapsed to per-axis matrices.

Port of ``sifsr_tpu/ops/psf.py``. The reference degrades super-resolved LST
back to sensor resolution with a chain of small linear ops (reference
utils.py:1615-1894):

    reflect-pad(hkw) -> depthwise 2-D Gaussian PSF conv (zero 'same' padding)
    -> bicubic 1/factor decimation -> border crop            [deci_type='bic']
or
    reflect-pad(hkw) -> PSF conv -> crop -> norm-L4 4x4 pool  [deci_type='norm-L4']

The PSF is an unnormalised separable Gaussian, and every step except the
norm-L4 pool is linear, so the whole chain composes into ONE dense per-axis
matrix ``M (out, in)``, precomputed in float64:

    downscale(x) = M_h @ x @ M_w^T

exact with respect to the reference composition including its quirks (the
zero padding the reference's ``padding='same'`` conv applies on top of the
explicit reflect pad, and the fact that the cropped outputs never see it).
The two products are plain ``torch.matmul``s here, as they are XLA matmuls
in the JAX package; the fused kernel form is ``kernels/fused_ops.py``.

Reference quirk preserved deliberately: ``downscale_LST_SR_to_LR_test``
(utils.py:1716-1756, used by the scale-invariance dataset at
dataset.py:257-263) never applies the PSF conv: it pads, decimates or pools,
and crops only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sifsr_tpu_torch.ops.pooling import norm_l4_downsample
from sifsr_tpu_torch.ops.resize import resize_matrix

__all__ = [
    "generate_psf_kernel",
    "psf_kernel_1d",
    "downscale_matrix",
    "lowpass_matrix",
    "downscale_lst_sr_to_lr",
    "downscale_lst_sr_to_lr_test",
    "lowpass_ftm",
]


def _psf_sigma(mtf_res: float, mtf_fc: float) -> float:
    """Std-dev of the Gaussian PSF whose MTF equals ``mtf_fc`` at the Nyquist
    frequency of the target resolution (reference utils.py:1621-1622)."""
    fc = 0.5 / mtf_res
    return math.sqrt(-math.log(mtf_fc) / 2.0) / (math.pi * fc)


def _half_kernel_width(res: float, mtf_res: float, hkw: int | None) -> int:
    return int(math.ceil(mtf_res / res)) if hkw is None else hkw


def psf_kernel_1d(
    res: float, mtf_res: float, mtf_fc: float, half_kernel_width: int | None = None
) -> np.ndarray:
    """1-D Gaussian profile g such that the reference's normalised 2-D PSF
    equals outer(g, g) (float64)."""
    sigma = _psf_sigma(mtf_res, mtf_fc)
    hkw = _half_kernel_width(res, mtf_res, half_kernel_width)
    taps = np.arange(-hkw, hkw + 1, dtype=np.float64) * res
    g = np.exp(-(taps * taps) / (2.0 * sigma * sigma))
    return g / g.sum()


def generate_psf_kernel(
    res: float, mtf_res: float, mtf_fc: float, half_kernel_width: int | None = None
) -> np.ndarray:
    """Normalised 2-D Gaussian PSF, numerically equal to reference
    utils.py:1615-1639 (the Gaussian is separable, so outer(g, g) with each
    factor normalised reproduces kernel/sum(kernel))."""
    g = psf_kernel_1d(res, mtf_res, mtf_fc, half_kernel_width)
    return np.outer(g, g).astype(np.float32)


def _reflect_pad_matrix(n: int, hw: int) -> np.ndarray:
    """(n + 2hw, n) matrix implementing torch 'reflect' padding (no edge dup)."""
    mat = np.zeros((n + 2 * hw, n), dtype=np.float64)
    for i in range(n + 2 * hw):
        j = i - hw
        if j < 0:
            j = -j
        elif j >= n:
            j = 2 * n - 2 - j
        mat[i, j] = 1.0
    return mat


def _conv_same_matrix(n: int, g: np.ndarray) -> np.ndarray:
    """(n, n) matrix of a zero-padded 'same' 1-D convolution with symmetric
    kernel g (length 2hw+1). Matches torch conv2d(padding='same')."""
    hw = (len(g) - 1) // 2
    mat = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k in range(len(g)):
            j = i + k - hw
            if 0 <= j < n:
                mat[i, j] += g[k]
    return mat


def _crop_matrix(n: int, lo: int, hi: int) -> np.ndarray:
    """(n - lo - hi, n) row-selection matrix x[lo : n - hi]."""
    out = n - lo - hi
    mat = np.zeros((out, n), dtype=np.float64)
    mat[np.arange(out), np.arange(lo, lo + out)] = 1.0
    return mat


@functools.lru_cache(maxsize=None)
def downscale_matrix(
    in_size: int,
    factor: int = 4,
    mtf: float = 0.1,
    hkw: int | None = None,
    deci_type: str = "bic",
    apply_psf: bool = True,
) -> np.ndarray:
    """Per-axis float64 matrix of the reference downscale chain
    (utils.py:1671-1714). The cached array is shared: treat it as read-only.

    deci_type='bic'      -> full chain, returns (in_size//factor, in_size)
    deci_type='norm-L4'  -> only the linear prefix pad->conv->crop, returns
                            (in_size, in_size); follow with norm_l4_downsample.
    apply_psf=False reproduces the `_test` variant's missing conv
    (utils.py:1740-1756).
    """
    hw = _half_kernel_width(1.0, float(factor), hkw)
    g = psf_kernel_1d(1.0, float(factor), mtf, hkw)
    padded = in_size + 2 * hw

    mat = _reflect_pad_matrix(in_size, hw)
    if apply_psf:
        mat = _conv_same_matrix(padded, g) @ mat

    if deci_type == "bic":
        mat = resize_matrix(padded, padded // factor, "cubic") @ mat
        size_loss = hw // factor
        mat = _crop_matrix(padded // factor, size_loss, size_loss) @ mat
    elif deci_type == "norm-L4":
        mat = _crop_matrix(padded, hw, hw) @ mat
    else:
        raise ValueError(f"unknown deci_type: {deci_type!r}")
    return mat


@functools.lru_cache(maxsize=None)
def lowpass_matrix(in_size: int, factor: int = 4, mtf: float = 0.1, hkw: int | None = None) -> np.ndarray:
    """Per-axis matrix of get_output_ftm (utils.py:1833-1860): PSF low-pass
    with reflect pad, zero-'same' conv and crop back to in_size. (in, in)."""
    hw = _half_kernel_width(1.0, float(factor), hkw)
    g = psf_kernel_1d(1.0, float(factor), mtf, hkw)
    padded = in_size + 2 * hw
    mat = _conv_same_matrix(padded, g) @ _reflect_pad_matrix(in_size, hw)
    return _crop_matrix(padded, hw, hw) @ mat


@functools.lru_cache(maxsize=64)
def _matrix_tensor(make, args: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(make(*args), dtype=dtype, device=device)


def _apply_axis_matrices(x: torch.Tensor, make, *args) -> torch.Tensor:
    """``M @ x @ Mᵀ`` over the trailing (H, W) axes, M = make(*args) in x's
    dtype, rows first. Full float32 as long as
    ``torch.backends.cuda.matmul.allow_tf32`` is off (its default)."""
    m = _matrix_tensor(make, args, x.dtype, x.device)
    return torch.matmul(torch.matmul(m, x), m.T)


def downscale_lst_sr_to_lr(
    x: torch.Tensor,
    factor: int = 4,
    mtf: float = 0.1,
    hkw: int | None = None,
    deci_type: str = "bic",
) -> torch.Tensor:
    """Differentiable SR->LR degradation on (..., H, W); reference
    utils.py:1671-1714 semantics, as two matmuls (+ norm-L4)."""
    if deci_type == "bic":
        return _apply_axis_matrices(x, downscale_matrix, x.shape[-1], factor, mtf, hkw, "bic", True)
    y = _apply_axis_matrices(x, downscale_matrix, x.shape[-1], factor, mtf, hkw, "norm-L4", True)
    return norm_l4_downsample(y, factor)


def downscale_lst_sr_to_lr_test(
    x: torch.Tensor,
    factor: int = 4,
    mtf: float = 0.1,
    hkw: int | None = None,
    deci_type: str = "bic",
) -> torch.Tensor:
    """Quirk-exact port of the `_test` variant (utils.py:1716-1756): the PSF
    conv is skipped (reference bug kept for data parity: the scale-invariance
    dataset was built with it, dataset.py:257-263)."""
    if deci_type == "bic":
        return _apply_axis_matrices(x, downscale_matrix, x.shape[-1], factor, mtf, hkw, "bic", False)
    # pad followed by symmetric crop cancels exactly -> pure norm-L4 pool.
    return norm_l4_downsample(x, factor)


def lowpass_ftm(x: torch.Tensor, factor: int = 4, mtf: float = 0.1, hkw: int | None = None) -> torch.Tensor:
    """PSF low-pass without decimation (get_output_ftm, utils.py:1833-1860).
    The gradFTM perceptual loss uses mtf=0.25 (train_model_B_gradFTM.py:108)."""
    return _apply_axis_matrices(x, lowpass_matrix, x.shape[-1], factor, mtf, hkw)
