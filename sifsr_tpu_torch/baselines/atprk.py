"""ATPRK: Area-To-Point Regression Kriging sharpening.

Port of ``sifsr_tpu/baselines/atprk.py``: the same numpy and scipy.

Behavioural port of the reference's Thunmpy-derived implementation
(utils.py:939-1253), with every O(N⁴) Python loop vectorised:

1. TsHARP-style global regression + fine-scale unmixing;
2. empirical semivariogram of the coarse regression residuals over all
   interior block_size×block_size windows (reference loops per window/pair,
   utils.py:1021-1049 -> sliding_window_view + distance-bucket masks here);
3. exponential-model fit sill·(1-exp(-d/(ran/3))) via scipy curve_fit('lm');
4. variogram deconvolution: find fine-scale (sill, ran) whose block-averaged
   (regularised) variogram matches the coarse fit (utils.py:944-975,1070-1110);
5. area-to-point kriging weights from the [[Γcc, 1],[1ᵀ, 0]] system
   (utils.py:1167-1182);
6. kriged fine-scale residual surface added to the unmixed estimate
   (utils.py:1184-1211).
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as opt
from numpy.lib.stride_tricks import sliding_window_view

from sifsr_tpu_torch.baselines.tsharp import coarse_residual, global_fit

__all__ = ["atprk", "empirical_variogram", "build_dis_f", "kriging_lambdas", "apply_residual_kriging"]


def _exp_model(d, sill, ran):
    return sill * (1.0 - np.exp(-d / (ran / 3.0)))


def _block_coords(block_size: int, scc: float) -> np.ndarray:
    """(block_size², 2) row-major coords of a coarse block at spacing scc."""
    rr, cc = np.meshgrid(np.arange(block_size), np.arange(block_size), indexing="ij")
    return np.stack([rr.ravel() * scc, cc.ravel() * scc], axis=1)


def empirical_variogram(delta_t: np.ndarray, block_size: int, scc: float):
    """Mean semivariogram over all interior windows -> (pd_uni, gamma).

    Matches reference utils.py:1008-1051: per window, gamma(d) =
    sum over pairs at distance d of (vi - vj)² / (2·n_pairs); windows whose
    entry is exactly 0 are excluded from the cross-window mean; NaN -> 0.
    """
    b_radius = block_size // 2
    coords = _block_coords(block_size, scc)
    diff = coords[:, None, :] - coords[None, :, :]
    pd_c = np.sqrt((diff**2).sum(-1))
    pd_uni = np.unique(pd_c)

    windows = sliding_window_view(delta_t, (block_size, block_size))
    w = windows.reshape(-1, block_size * block_size)
    # pairwise squared differences per window: (nwin, P, P)
    d2 = (w[:, :, None] - w[:, None, :]) ** 2

    gamma = np.zeros(len(pd_uni))
    iu, ju = np.triu_indices(block_size**2, k=1)
    pair_dist = pd_c[iu, ju]
    pair_vals = d2[:, iu, ju]  # (nwin, npairs)
    for k, d in enumerate(pd_uni):
        if d == 0:
            continue
        sel = pair_dist == d
        per_window = pair_vals[:, sel].sum(axis=1) / (2.0 * sel.sum())
        nz = per_window[per_window != 0]
        gamma[k] = nz.mean() if nz.size else 0.0
    gamma[np.isnan(gamma)] = 0.0
    return pd_uni, gamma, pd_c


def build_dis_f(block_size: int, iscale: int, scc: float) -> np.ndarray:
    """(N_c, N_c, iscale², iscale²) distances between the fine pixels of every
    pair of coarse pixels in the block (reference utils.py:1070-1100)."""
    fine_pix = np.arange(iscale)
    by, bx = np.meshgrid(np.arange(block_size), np.arange(block_size), indexing="ij")
    blocks = np.stack([by.ravel(), bx.ravel()], 1)  # (N_c, 2) row-major
    fy, fx = np.meshgrid(fine_pix, fine_pix, indexing="ij")
    fines = np.stack([fy.ravel(), fx.ravel()], 1)  # (iscale², 2) row-major

    # global fine coords: block*iscale + fine, spacing scc/iscale
    pos = (blocks[:, None, :] * iscale + fines[None, :, :]) * (scc / iscale)  # (N_c, F, 2)
    diff = pos[:, None, :, None, :] - pos[None, :, None, :, :]
    return np.sqrt((diff**2).sum(-1))  # (N_c, N_c, F, F)


def _gamma_cc_from_fine(sill, ran, dis_f):
    """Γcc[i,j] = mean over fine pairs of the fine-scale exponential model."""
    return _exp_model(dis_f, sill, ran).mean(axis=(2, 3))


def _regularised(sill, ran, dis_f, pd_c, pd_uni):
    gcc = _gamma_cc_from_fine(sill, ran, dis_f)
    out = np.array([gcc[pd_c == d].mean() for d in pd_uni])
    return out - out[0]


def kriging_lambdas(sill_f, ran_f, dis_f, block_size, iscale):
    """ATPK weights: λ (iscale², N_c) from the central-coarse-pixel system
    (utils.py:1117-1182)."""
    n_c = block_size**2
    gcc = _gamma_cc_from_fine(sill_f, ran_f, dis_f)
    central = int(np.floor(0.5 * block_size**2))
    # Γfc: fine pixels of the central coarse pixel vs every coarse pixel;
    # dis_f[central] is (N_c, F_i, F_j) -> mean over F_j, transpose -> (F, N_c)
    gfc = _exp_model(dis_f[central], sill_f, ran_f).mean(axis=2).T

    a = np.zeros((n_c + 1, n_c + 1))
    a[:n_c, :n_c] = gcc
    a[:n_c, n_c] = 1.0
    a[n_c, :n_c] = 1.0
    a_inv = np.linalg.inv(a)
    b = np.concatenate([gfc, np.ones((iscale * iscale, 1))], axis=1)  # (F, N_c+1)
    lambdas = (a_inv @ b.T).T[:, :n_c]
    return lambdas


def apply_residual_kriging(
    delta_t: np.ndarray,
    tt_unm: np.ndarray,
    lambdas: np.ndarray,
    block_size: int,
    iscale: int,
) -> np.ndarray:
    """Kriged fine residual surface (utils.py:1184-1211), vectorised.

    Interior coarse pixels only (b_radius border of the fine grid stays 0);
    fine pixels where the unmixed estimate is 0 stay 0."""
    b_radius = block_size // 2
    rows_c, cols_c = delta_t.shape
    windows = sliding_window_view(delta_t, (block_size, block_size))  # (r', c', B, B)
    w = windows.reshape(windows.shape[0], windows.shape[1], -1)  # (r', c', N_c)

    # fine offsets are row-major (fy, fx): contribution (r', c', F)
    contrib = np.einsum("rck,fk->rcf", w, lambdas)
    n_rows_f, n_cols_f = rows_c * iscale, cols_c * iscale
    delta_fine = np.zeros((n_rows_f, n_cols_f))
    # scatter: coarse (ir, ic) interior -> fine block [ir*s:(ir+1)*s)
    r0, r1 = b_radius, rows_c - b_radius
    c0, c1 = b_radius, cols_c - b_radius
    block = contrib.reshape(r1 - r0, c1 - c0, iscale, iscale)
    fine_view = delta_fine[r0 * iscale : r1 * iscale, c0 * iscale : c1 * iscale]
    fine_view[:] = block.transpose(0, 2, 1, 3).reshape(fine_view.shape)

    delta_fine[tt_unm == 0] = 0.0
    return delta_fine


def atprk(
    temp_coarse: np.ndarray,
    index_coarse: np.ndarray,
    index_fine: np.ndarray,
    scale: int = 4,
    scc: float = 926.0,
    block_size: int = 5,
    sill: float = 7.0,
    ran: float = 1000.0,
    min_t: float = 285.0,
) -> np.ndarray:
    """Full ATPRK sharpening (reference utils.py:1234-1253 defaults)."""
    slope, intercept = global_fit(index_coarse, temp_coarse, min_t)

    temp_fine = intercept + slope * index_fine
    mask_fine = np.repeat(np.repeat(temp_coarse != 0, scale, 0), scale, 1)
    temp_fine = temp_fine * mask_fine

    delta_t = coarse_residual(index_coarse, temp_coarse, slope, intercept)

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
