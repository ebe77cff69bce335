"""AATPRK: Adaptive ATPRK with per-pixel windowed regressions.

Port of ``sifsr_tpu/baselines/aatprk.py``: the same numpy and scipy.

Behavioural port of reference utils.py:1256-1606. Differences from ATPRK:
the NDVI->LST regression is fitted per coarse pixel over a sliding window
(falling back to the global fit when fewer than 2/3 of the window's pixels
are valid, and on the image border), and the unmixing/residual use the
spatially-varying slope/intercept.

The reference's per-pixel linregress loop (utils.py:1285-1305) becomes a
masked closed-form least squares over sliding windows — one vectorised pass.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as opt
from numpy.lib.stride_tricks import sliding_window_view

from sifsr_tpu_torch.baselines.atprk import (
    _exp_model,
    _regularised,
    apply_residual_kriging,
    build_dis_f,
    empirical_variogram,
    kriging_lambdas,
)
from sifsr_tpu_torch.baselines.tsharp import global_fit

__all__ = ["aatprk", "windowed_fit"]


def windowed_fit(
    index_coarse: np.ndarray,
    temp_coarse: np.ndarray,
    min_t: float,
    b_radius: int,
):
    """Per-pixel windowed linear regression -> (a0 intercept map, a1 slope map).

    Valid pixels: T > min_t and finite NDVI. A window needs more than
    2/3·(2b+1)² valid samples, else the global fit is used (also on the
    border), matching reference utils.py:1285-1325.
    """
    rows, cols = temp_coarse.shape
    g_slope, g_intercept = global_fit(index_coarse, temp_coarse, min_t)
    w = 2 * b_radius + 1

    valid = (temp_coarse > min_t) & np.isfinite(index_coarse)
    t = np.where(valid, temp_coarse, 0.0)
    i = np.where(valid, index_coarse, 0.0)

    def win_sum(x):
        return sliding_window_view(x, (w, w)).sum(axis=(2, 3))

    n = win_sum(valid.astype(np.float64))
    sx = win_sum(i)
    sy = win_sum(t)
    sxx = win_sum(i * i)
    sxy = win_sum(i * t)

    denom = n * sxx - sx * sx
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = (n * sxy - sx * sy) / denom
        intercept = (sy - slope * sx) / n

    enough = n > (2.0 / 3.0) * w * w
    ok = enough & np.isfinite(slope) & np.isfinite(intercept)
    slope = np.where(ok, slope, g_slope)
    intercept = np.where(ok, intercept, g_intercept)

    a1 = np.full((rows, cols), g_slope)
    a0 = np.full((rows, cols), g_intercept)
    a1[b_radius : rows - b_radius, b_radius : cols - b_radius] = slope
    a0[b_radius : rows - b_radius, b_radius : cols - b_radius] = intercept
    return a0, a1


def aatprk(
    temp_coarse: np.ndarray,
    index_coarse: np.ndarray,
    index_fine: np.ndarray,
    scale: int = 4,
    scc: float = 926.0,
    block_size: int = 5,
    sill: float = 7.0,
    ran: float = 1000.0,
    min_t: float = 285.0,
    fit_radius: int = 2,
) -> np.ndarray:
    """Full AATPRK sharpening (reference utils.py:1588-1606 composition)."""
    a0, a1 = windowed_fit(index_coarse, temp_coarse, min_t, fit_radius)

    # adaptive unmixing (utils.py:1333-1351): fine pixel uses its coarse
    # pixel's regression; background (NDVI == 0) stays 0
    a0_fine = np.repeat(np.repeat(a0, scale, 0), scale, 1)
    a1_fine = np.repeat(np.repeat(a1, scale, 0), scale, 1)
    temp_fine = np.where(np.abs(index_fine) > 0, a0_fine + a1_fine * index_fine, 0.0)

    modelled = a0 + a1 * index_coarse
    modelled[temp_coarse <= 0] = 0.0
    delta_t = temp_coarse - modelled

    pd_uni, gamma_coarse, pd_c = empirical_variogram(delta_t, block_size, scc)
    (sill_c, ran_c), _ = opt.curve_fit(
        _exp_model, pd_uni, gamma_coarse, p0=[sill, ran], method="lm"
    )
    dis_f = build_dis_f(block_size, scale, scc)
    (sill_f, ran_f), _ = opt.curve_fit(
        lambda d, s, r: _regularised(s, r, dis_f, pd_c, pd_uni),
        pd_uni,
        gamma_coarse,
        p0=[sill_c, ran_c],
        method="lm",
    )
    lambdas = kriging_lambdas(sill_f, ran_f, dis_f, block_size, scale)
    delta_fine = apply_residual_kriging(delta_t, temp_fine, lambdas, block_size, scale)
    return temp_fine + delta_fine
