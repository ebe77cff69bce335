"""TsHARP: global NDVI->LST regression sharpening (reference utils.py:854-936,
1213-1231; Thunmpy lineage).

Port of ``sifsr_tpu/baselines/tsharp.py``: the same numpy and scipy.

Algorithm:
1. fit a global linear regression LST ~ NDVI at coarse scale over valid
   pixels (T > min_T, finite NDVI);
2. apply it at fine scale (masked by a nearest-neighbour upsample of the
   coarse validity mask);
3. add back the block-replicated coarse residual (measured - modelled), zeroed
   where the fine estimate is invalid.

The reference's quadruple block-replication loop (utils.py:922-929) is a
numpy ``repeat`` here.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import linregress

__all__ = ["tsharp", "global_fit", "coarse_residual"]


def global_fit(index_coarse: np.ndarray, temp_coarse: np.ndarray, min_t: float):
    """Global LST~NDVI regression over valid coarse pixels -> (slope, intercept)."""
    t = temp_coarse.ravel()
    i = index_coarse.ravel()
    valid = (t > min_t) & np.isfinite(i)
    fit = linregress(i[valid], t[valid])
    return fit.slope, fit.intercept


def coarse_residual(
    index_coarse: np.ndarray, temp_coarse: np.ndarray, slope: float, intercept: float
) -> np.ndarray:
    """Delta_T = measured - modelled at coarse scale, background zeroed."""
    modelled = intercept + slope * index_coarse
    modelled[temp_coarse <= 0] = 0.0
    return temp_coarse - modelled


def tsharp(
    temp_coarse: np.ndarray,
    index_coarse: np.ndarray,
    index_fine: np.ndarray,
    scale: int = 4,
    min_t: float = 285.0,
) -> np.ndarray:
    """Sharpen ``temp_coarse`` (H, W) to (H*scale, W*scale) guided by NDVI."""
    slope, intercept = global_fit(index_coarse, temp_coarse, min_t)

    # fine-scale unmixing, masked by NN-upsampled coarse validity (utils.py:886-889)
    temp_fine = intercept + slope * index_fine
    mask_fine = np.repeat(np.repeat(temp_coarse != 0, scale, 0), scale, 1)
    temp_fine = temp_fine * mask_fine

    # block-replicated coarse residual, zeroed on invalid fine pixels
    delta = coarse_residual(index_coarse, temp_coarse, slope, intercept)
    delta_fine = np.repeat(np.repeat(delta, scale, 0), scale, 1)
    delta_fine[temp_fine == 0] = 0.0
    return temp_fine + delta_fine
