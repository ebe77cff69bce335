"""Separable image resampling as precomputed matrices.

Port of ``sifsr_tpu/ops/resize.py``. The reference pipeline resamples with
cv2 ``INTER_CUBIC`` (dataset bicubic x4 upsample) and torch align-corners
bilinear x2 (the U-Net decoder). Both are linear maps with a fixed tap
pattern, so each axis gets a dense ``(out, in)`` float64 matrix and the
resize is two matmuls, ``y = A_h @ x @ A_w^T``:

- cubic kernel: Keys with A = -0.75 (cv2 and torch both use it);
- half-pixel mapping ``x_src = (i + 0.5) * in/out - 0.5`` with edge-clamped
  taps;
- align_corners=True linear mapping ``x_src = i * (in-1)/(out-1)``.

``F.interpolate`` is not used: the contract is cv2 ``INTER_CUBIC`` parity,
which these matrices reproduce exactly (same kernel, grid and clamping).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "resize_matrix",
    "upsample_bicubic",
    "upsample_bilinear_x2",
]

_A = -0.75  # Keys cubic coefficient used by cv2 INTER_CUBIC and torch bicubic.


def _cubic_weight(t: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with A=-0.75, evaluated elementwise on |t|."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        ((_A + 2.0) * t - (_A + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, ((_A * t - 5.0 * _A) * t + 8.0 * _A) * t - 4.0 * _A, 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int, kind: str = "cubic") -> np.ndarray:
    """Dense (out_size, in_size) float64 resampling matrix for one axis.

    kind:
      'cubic'      half-pixel bicubic, A=-0.75, clamped taps (cv2/torch parity)
      'linear_ac'  bilinear with align_corners=True (torch Upsample parity)

    The cached array is shared by every caller: treat it as read-only.
    """
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if kind == "cubic":
        scale = in_size / out_size
        for i in range(out_size):
            x = (i + 0.5) * scale - 0.5
            ix = int(np.floor(x))
            taps = np.arange(ix - 1, ix + 3)
            weights = _cubic_weight(taps - x)
            # cv2/torch clamp out-of-range taps to the border pixel; the tiny
            # float64 residue of the weight sum is kept (matches torch)
            np.add.at(mat[i], np.clip(taps, 0, in_size - 1), weights)
    elif kind == "linear_ac":
        if out_size == 1:
            mat[0, 0] = 1.0
            return mat
        scale = (in_size - 1) / (out_size - 1) if in_size > 1 else 0.0
        for i in range(out_size):
            x = i * scale
            ix = min(int(np.floor(x)), in_size - 2) if in_size > 1 else 0
            frac = x - ix
            mat[i, ix] += 1.0 - frac
            if in_size > 1:
                mat[i, ix + 1] += frac
    else:
        raise ValueError(f"unknown resize kind: {kind!r}")
    return mat


@functools.lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, kind: str, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    return torch.as_tensor(resize_matrix(in_size, out_size, kind), dtype=dtype,
                           device=device)


def _apply_separable(x: torch.Tensor, out_h: int, out_w: int, kind: str) -> torch.Tensor:
    """Resize the trailing (H, W) axes: rows first, then columns, in x's dtype."""
    h, w = x.shape[-2], x.shape[-1]
    mat_h = _matrix(h, out_h, kind, x.dtype, x.device)
    mat_w = _matrix(w, out_w, kind, x.dtype, x.device)
    return torch.matmul(torch.matmul(mat_h, x), mat_w.T)


def upsample_bicubic(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """cv2.INTER_CUBIC x`factor` upsample of (..., H, W) (reference utils.py:163-180)."""
    h, w = x.shape[-2], x.shape[-1]
    return _apply_separable(x, h * factor, w * factor, "cubic")


def upsample_bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """torch Upsample(scale_factor=2, bilinear, align_corners=True) on (..., H, W)."""
    h, w = x.shape[-2], x.shape[-1]
    return _apply_separable(x, 2 * h, 2 * w, "linear_ac")


@functools.lru_cache(maxsize=None)
def _upsample_stencil(in_size: int, factor: int, kind: str):
    """Decompose an integer-factor upsample matrix into per-phase shift
    coefficients: out[f*k + d] = sum_delta C[d, delta][k] * x[k + delta].

    Every row of resize_matrix(in, f*in) has its (clamp-accumulated) support
    in a small window around k, so the resize is a varying-coefficient
    small stencil (kernels/resize_phases.py runs it). Returns
    {(d, delta): coeff (in_size,) float64}; a coefficient is exactly 0 where
    k + delta leaves [0, in_size)."""
    a = resize_matrix(in_size, factor * in_size, kind)
    coeffs: dict = {}
    for o in range(factor * in_size):
        k, d = divmod(o, factor)
        for h in np.nonzero(a[o])[0]:
            key = (d, int(h) - k)
            if key not in coeffs:
                coeffs[key] = np.zeros(in_size, np.float64)
            coeffs[key][k] = a[o, h]
    return {k: v for k, v in sorted(coeffs.items())}
