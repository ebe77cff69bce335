"""Raster reprojection (the gdalwarp replacement for the eval harness).

The port's own copy of ``sifsr_tpu/geo/warp.py`` (numpy only).

Implements inverse-mapping warping: for every destination pixel centre in the
destination CRS, transform back to the source CRS, then sample the source
raster bilinearly (gdalwarp's ``-r bilinear`` used by the reference,
model_perf_aster_formatds.py:163,312-317).

Grid choice follows gdalwarp's suggested-warp-output logic closely enough for
the eval's purposes: destination bounds = transformed source corner/edge
samples; destination pixel size preserves the source pixel diagonal.
"""

from __future__ import annotations

import numpy as np

from sifsr_tpu_torch.geo import projection as prj
from sifsr_tpu_torch.geo.tiff import GeoTiff

__all__ = [
    "warp_sinusoidal_to_utm",
    "bilinear_sample",
    "bounds_of",
    "suggested_warp_grid",
]


def suggested_warp_grid(
    shape: tuple[int, int], src_gt: tuple, epsg: int
) -> tuple[tuple, tuple[int, int]]:
    """gdalwarp's default output grid for a sinusoidal->UTM warp.

    Replicates GDALSuggestedWarpOutput2 (gdal/alg/gdaltransformer.cpp), which
    gdalwarp uses when no -te/-tr is given (the reference warps the full
    4800x4800 canvas with plain ``gdalwarp -s_srs .. -t_srs .. -r bilinear``,
    model_perf_aster_formatds.py:312-317):

    - bounds = min/max of the transformed source outline (21 samples/edge);
    - nominal pixel size = transformed (0,0)->(W,H) corner diagonal divided
      by the source diagonal in pixels;
    - pixel count = extent/size rounded to nearest; the final pixel sizes are
      then re-fit exactly to the extent (so X and Y sizes differ slightly).

    Returns (geotransform, (height, width)).
    """
    h, w = shape
    ts = np.linspace(0, 1, 21)
    edge_cols = np.concatenate([ts * w, np.full(21, w), ts[::-1] * w, np.zeros(21)])
    edge_rows = np.concatenate([np.zeros(21), ts * h, np.full(21, h), ts[::-1] * h])
    sx = src_gt[0] + edge_cols * src_gt[1]
    sy = src_gt[3] + edge_rows * src_gt[5]
    ex, ny = prj.sinusoidal_to_utm(sx, sy, epsg)
    left, right = float(ex.min()), float(ex.max())
    bottom, top = float(ny.min()), float(ny.max())

    cx = src_gt[0] + np.array([0.0, w]) * src_gt[1]
    cy = src_gt[3] + np.array([0.0, h]) * src_gt[5]
    cex, cny = prj.sinusoidal_to_utm(cx, cy, epsg)
    diag = float(np.hypot(cex[1] - cex[0], cny[1] - cny[0]))
    ps = diag / float(np.hypot(w, h))

    n_px = int((right - left) / ps + 0.5)
    n_ln = int((top - bottom) / ps + 0.5)
    ps_x = (right - left) / n_px
    ps_y = (top - bottom) / n_ln
    return (left, ps_x, 0.0, top, 0.0, -ps_y), (n_ln, n_px)


def bounds_of(shape: tuple[int, int], gt: tuple) -> tuple[float, float, float, float]:
    """(left, bottom, right, top) of a north-up raster."""
    h, w = shape
    left, top = gt[0], gt[3]
    right = gt[0] + w * gt[1]
    bottom = gt[3] + h * gt[5]
    return left, bottom, right, top


def bilinear_sample(img: np.ndarray, rows: np.ndarray, cols: np.ndarray, fill: float = 0.0) -> np.ndarray:
    """Bilinear sample ``img`` at fractional (rows, cols); outside -> fill."""
    h, w = img.shape
    valid = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    r = np.clip(rows, 0, h - 1)
    c = np.clip(cols, 0, w - 1)
    r0 = np.clip(np.floor(r).astype(np.int64), 0, h - 2)
    c0 = np.clip(np.floor(c).astype(np.int64), 0, w - 2)
    fr = r - r0
    fc = c - c0
    v00 = img[r0, c0]
    v01 = img[r0, c0 + 1]
    v10 = img[r0 + 1, c0]
    v11 = img[r0 + 1, c0 + 1]
    out = (
        v00 * (1 - fr) * (1 - fc)
        + v01 * (1 - fr) * fc
        + v10 * fr * (1 - fc)
        + v11 * fr * fc
    )
    return np.where(valid, out, fill)


def warp_sinusoidal_to_utm(
    src: np.ndarray,
    src_gt: tuple,
    epsg: int,
    dst_gt: tuple | None = None,
    dst_shape: tuple[int, int] | None = None,
    fill: float = 0.0,
) -> GeoTiff:
    """Warp a north-up sinusoidal raster to a UTM grid (bilinear).

    Without an explicit destination grid, bounds come from transforming a
    21-point sampling of the source outline and the pixel size preserves the
    source pixel diagonal (gdalwarp behaviour).
    """
    h, w = src.shape
    if dst_gt is None or dst_shape is None:
        # sample the source outline
        ts = np.linspace(0, 1, 21)
        edge_cols = np.concatenate([ts * w, np.full(21, w), ts[::-1] * w, np.zeros(21)])
        edge_rows = np.concatenate([np.zeros(21), ts * h, np.full(21, h), ts[::-1] * h])
        sx = src_gt[0] + edge_cols * src_gt[1]
        sy = src_gt[3] + edge_rows * src_gt[5]
        ex, ny = prj.sinusoidal_to_utm(sx, sy, epsg)
        left, right = float(ex.min()), float(ex.max())
        bottom, top = float(ny.min()), float(ny.max())
        # preserve pixel diagonal: sinusoidal pixels are square |gt[1]|
        res = abs(src_gt[1])
        dst_w = int(np.ceil((right - left) / res))
        dst_h = int(np.ceil((top - bottom) / res))
        dst_gt = (left, res, 0.0, top, 0.0, -res)
        dst_shape = (dst_h, dst_w)

    dh, dw = dst_shape
    jj, ii = np.meshgrid(np.arange(dw), np.arange(dh))
    dst_x = dst_gt[0] + (jj + 0.5) * dst_gt[1]
    dst_y = dst_gt[3] + (ii + 0.5) * dst_gt[5]

    src_x, src_y = prj.utm_to_sinusoidal(dst_x, dst_y, epsg)
    cols = (src_x - src_gt[0]) / src_gt[1] - 0.5
    rows = (src_y - src_gt[3]) / src_gt[5] - 0.5

    out = bilinear_sample(np.asarray(src, np.float64), rows, cols, fill=fill)
    return GeoTiff(array=out.astype(np.float32), geotransform=dst_gt)
