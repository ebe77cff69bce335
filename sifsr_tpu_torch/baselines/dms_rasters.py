"""Unaligned-raster DMS workflow (the reference's ORIGINAL
data_mining_sharpener.py, not the `_modified` patch variant).

Port of ``sifsr_tpu/baselines/dms_rasters.py``, on the port's DMS (its
regressors fitted and applied on ``device``, default ``cuda``) and
``geo.warp.bilinear_sample``; the grid arithmetic is the JAX package's numpy.

The reference ships two DMS entry points: `data_mining_sharpener_modified.py`
bypasses reprojection for already-aligned integer-factor patches (rebuilt in
baselines/dms.py — the configuration the ASTER evaluation actually uses,
model_perf_aster_formatds.py:241-250), while the original
`data_mining_sharpener.py:429-583` sharpens ARBITRARY raster pairs: the
high-resolution scene is gdalwarp-resampled (average) onto the
low-resolution scene's grid for training, prediction runs on the HR grid,
and the residual bias correction moves between the two grids with
gdalwarp average/bilinear resampling.

This rebuild keeps that capability without GDAL: grid<->grid resampling is
done with the repo's own geotransform math (geo.warp) — per-cell average
binning of source pixel centers for HR->LR (gdalwarp -r average semantics),
bilinear sampling at destination pixel centers for LR->HR (gdalwarp
-r bilinear). Rasters may live on any two grids of the SAME CRS, or on
different CRSs by passing ``to_lr``/``to_hr`` coordinate transforms (e.g.
geo.projection.sinusoidal_to_utm). The regression machinery (CV-weighted
homogeneous sampling, bagged leaf-ridge trees, optional Gao §2.3 moving
windows, radiance-space residual) is shared with baselines/dms.py.
"""

from __future__ import annotations

import numpy as np
import torch

from sifsr_tpu_torch.baselines.dms import DecisionTreeSharpener
from sifsr_tpu_torch.geo.warp import bilinear_sample

__all__ = ["bin_to_grid", "resample_bilinear_to_grid", "sharpen_rasters"]


def _px_centers(shape, gt):
    """(x, y) world coordinates of every pixel center of a (H, W) grid."""
    h, w = shape
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    x = gt[0] + (jj + 0.5) * gt[1] + (ii + 0.5) * gt[2]
    y = gt[3] + (jj + 0.5) * gt[4] + (ii + 0.5) * gt[5]
    return x, y


def bin_to_grid(src: np.ndarray, src_gt, dst_shape, dst_gt, transform=None):
    """Average-resample ``src`` onto an arbitrary destination grid
    (gdalwarp -r average semantics: mean of the source pixels whose centers
    fall inside each destination cell; reference
    data_mining_sharpener.py:489-517 resampleHighResToLowRes).

    src may be (H, W) or (H, W, B). transform(x, y) maps source-CRS
    coordinates into the destination CRS (None = same CRS). Returns
    (dst (dh, dw[, B]) with NaN where no source center landed, count)."""
    src = np.asarray(src, np.float64)
    bands = src[..., None] if src.ndim == 2 else src
    h, w, nb = bands.shape
    x, y = _px_centers((h, w), src_gt)
    if transform is not None:
        x, y = transform(x, y)
    # invert the (axis-aligned or rotated) destination geotransform
    det = dst_gt[1] * dst_gt[5] - dst_gt[2] * dst_gt[4]
    dx = x - dst_gt[0]
    dy = y - dst_gt[3]
    cols = np.floor((dx * dst_gt[5] - dy * dst_gt[2]) / det).astype(np.int64)
    rows = np.floor((dy * dst_gt[1] - dx * dst_gt[4]) / det).astype(np.int64)
    dh, dw = dst_shape
    ok = (rows >= 0) & (rows < dh) & (cols >= 0) & (cols < dw)
    flat = rows[ok] * dw + cols[ok]
    counts = np.bincount(flat, minlength=dh * dw).astype(np.float64)
    out = np.full((dh * dw, nb), np.nan)
    valid = counts > 0
    for b in range(nb):
        vals = bands[..., b][ok]
        finite = np.isfinite(vals)
        sums = np.bincount(flat[finite], weights=vals[finite], minlength=dh * dw)
        cnt = np.bincount(flat[finite], minlength=dh * dw).astype(np.float64)
        v = cnt > 0
        out[v, b] = sums[v] / cnt[v]
    out = out.reshape(dh, dw, nb)
    if src.ndim == 2:
        out = out[..., 0]
    return out, counts.reshape(dh, dw)


def resample_bilinear_to_grid(src: np.ndarray, src_gt, dst_shape, dst_gt,
                              transform=None, fill=np.nan):
    """Bilinear-sample ``src`` at the destination grid's pixel centers
    (gdalwarp -r bilinear; reference residual/LST resampling,
    data_mining_sharpener.py:929-954). transform maps destination-CRS
    coordinates into the source CRS."""
    x, y = _px_centers(dst_shape, dst_gt)
    if transform is not None:
        x, y = transform(x, y)
    det = src_gt[1] * src_gt[5] - src_gt[2] * src_gt[4]
    dx = x - src_gt[0]
    dy = y - src_gt[3]
    cols = (dx * src_gt[5] - dy * src_gt[2]) / det - 0.5
    rows = (dy * src_gt[1] - dx * src_gt[4]) / det - 0.5
    return bilinear_sample(np.asarray(src, np.float64), rows, cols, fill=fill)


class _RasterSharpener(DecisionTreeSharpener):
    """DecisionTreeSharpener whose training statistics come from grid
    binning instead of integer-factor block aggregation."""

    def train_rasters(self, hr_bands, hr_gt, lst_lr, lr_gt, to_lr=None):
        mean, _ = bin_to_grid(hr_bands, hr_gt, lst_lr.shape, lr_gt,
                              transform=to_lr)
        # per-cell CV needs second moments: bin the squares too
        sq, _ = bin_to_grid(np.asarray(hr_bands, np.float64) ** 2, hr_gt,
                            lst_lr.shape, lr_gt, transform=to_lr)
        if mean.ndim == 2:
            mean = mean[..., None]
            sq = sq[..., None]
        var = np.maximum(sq - mean**2, 0.0)
        safe_mean = np.where(mean == 0, 1e-6, mean)
        cv = (np.sqrt(var) / safe_mean).mean(axis=-1)
        cv[~np.isfinite(cv)] = 1000.0
        gh, gw = cv.shape

        self.local_regs = []
        if self.moving_window_size > 0:
            m, ext = self.moving_window_size, self.moving_window_extension
            for y0 in range(0, gh, m):
                for x0 in range(0, gw, m):
                    rows = slice(int(max(y0 - ext, 0)), int(min(y0 + m + ext, gh)))
                    cols = slice(int(max(x0 - ext, 0)), int(min(x0 + m + ext, gw)))
                    reg = self._fit_window(mean, lst_lr, cv, rows, cols)
                    self.local_regs.append(
                        ((slice(y0, min(y0 + m, gh)), slice(x0, min(x0 + m, gw))), reg))
        self.reg = self._fit_window(mean, lst_lr, cv, slice(0, gh), slice(0, gw))
        if self.reg is None:
            raise ValueError("not enough valid training samples for DMS")
        return self


def sharpen_rasters(
    lst_lr: np.ndarray,
    lr_gt,
    hr_bands: np.ndarray,
    hr_gt,
    to_lr=None,
    to_hr=None,
    disaggregating_temperature: bool = True,
    moving_window_size: int = 0,
    residual_correction: bool = True,
    device: str | torch.device = "cuda",
    **sharpener_opts,
) -> np.ndarray:
    """The original DMS pipeline on two arbitrary grids: returns the
    sharpened LST on the HIGH-resolution grid.

    lst_lr (lh, lw) Kelvin on grid lr_gt; hr_bands (hh, hw[, B]) (e.g. NDVI)
    on grid hr_gt. to_lr(x, y) maps HR-CRS -> LR-CRS world coordinates,
    to_hr the inverse (both None when the grids share a CRS). The
    regressors are fitted and applied on ``device``.

    Pipeline (reference data_mining_sharpener.py):
      1. average-bin HR bands onto the LR grid, train the CV-weighted bagged
         leaf-ridge ensemble on (binned bands -> LST) (:489-583);
      2. predict per HR pixel (+ optional Gao §2.3 moving-window locals,
         combined by inverse squared coarse residuals) (:649-872);
      3. residual bias correction in radiance space across the two grids:
         bin pred^4 to LR, residual = LST^4 - binned, bilinear-resample the
         residual back to HR, add, ^0.25 (:875-967).
    """
    hr = np.asarray(hr_bands, np.float64)
    sharp = _RasterSharpener(
        disaggregating_temperature=disaggregating_temperature,
        moving_window_size=moving_window_size,
        device=device,
        **sharpener_opts,
    ).train_rasters(hr, hr_gt, np.asarray(lst_lr, np.float64), lr_gt, to_lr=to_lr)

    fine = hr[..., None] if hr.ndim == 2 else hr
    pred = sharp._predict_fine(sharp.reg, fine)

    if moving_window_size > 0 and any(r is not None for _, r in sharp.local_regs):
        # map each HR pixel to its LR cell to locate its window
        x, y = _px_centers(pred.shape, hr_gt)
        if to_lr is not None:
            x, y = to_lr(x, y)
        det = lr_gt[1] * lr_gt[5] - lr_gt[2] * lr_gt[4]
        dx, dy = x - lr_gt[0], y - lr_gt[3]
        cc = np.floor((dx * lr_gt[5] - dy * lr_gt[2]) / det).astype(np.int64)
        rr = np.floor((dy * lr_gt[1] - dx * lr_gt[4]) / det).astype(np.int64)
        windowed = pred.copy()
        has_local = np.zeros(pred.shape, bool)
        for (rows, cols), reg in sharp.local_regs:
            if reg is None:
                continue
            sel = ((rr >= rows.start) & (rr < rows.stop)
                   & (cc >= cols.start) & (cc < cols.stop))
            if sel.any():
                windowed[sel] = reg.predict(fine[sel])
                has_local |= sel
        # combine by inverse squared LR-grid residuals (Gao 2012 §2.3)
        p = 4 if disaggregating_temperature else 1
        agg_w, _ = bin_to_grid(windowed**p, hr_gt, lst_lr.shape, lr_gt, to_lr)
        agg_f, _ = bin_to_grid(pred**p, hr_gt, lst_lr.shape, lr_gt, to_lr)
        rw = np.asarray(lst_lr, np.float64) ** p - agg_w
        rf = np.asarray(lst_lr, np.float64) ** p - agg_f
        eps = 1e-12
        w_lr = (1.0 / np.maximum(rw**2, eps)) / (
            1.0 / np.maximum(rw**2, eps) + 1.0 / np.maximum(rf**2, eps))
        w_hr = resample_bilinear_to_grid(np.nan_to_num(w_lr, nan=0.0), lr_gt,
                                         pred.shape, hr_gt, transform=to_hr,
                                         fill=0.0)
        w_hr = np.clip(w_hr, 0.0, 1.0)
        w_hr[~has_local] = 0.0
        pred = ((windowed**p) * w_hr + (pred**p) * (1.0 - w_hr)) ** (1.0 / p)

    if not residual_correction:
        return pred
    p = 4 if disaggregating_temperature else 1
    agg, _ = bin_to_grid(pred**p, hr_gt, lst_lr.shape, lr_gt, to_lr)
    residual_lr = np.asarray(lst_lr, np.float64) ** p - agg
    residual_hr = resample_bilinear_to_grid(
        np.nan_to_num(residual_lr, nan=0.0), lr_gt, pred.shape, hr_gt,
        transform=to_hr, fill=0.0)
    return np.power(np.maximum(pred**p + residual_hr, 0.0), 1.0 / p)
