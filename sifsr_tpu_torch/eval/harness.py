"""ASTER evaluation harness, the model_perf_aster_formatds.py rebuild (port of
``sifsr_tpu/eval/harness.py``).

For each test pair in test_data_formatted (83 ASTER-paired MODIS patches):

1. run the selected SR method (modelB / bicubic / TsHARP / ATPRK / AATPRK /
   DMS) on the 64x64 LST + 256x256 NDVI patch;
2. embed the SR patch, the NN-upsampled input LST and the NDVI into 4800x4800
   sinusoidal canvases at the pair's granule position
   (model_perf_aster_formatds.py:253-261);
3. reproject to the pair's UTM zone (our warp replaces the reference's three
   gdalwarp subprocesses, :312-317);
4. intersect with the ASTER 250m raster's bounds, resample ASTER bilinearly
   onto the warped grid scale, apply the x0.1 ASTER scale (:319-358);
5. crop both to the common valid quadrilateral via corner detection
   (utils.find_corners semantics, cv2.goodFeaturesToTrack, :360-369);
6. metrics: PSNR, SSIM, RMSE, RMSE stratified by ASTER high-frequency
   gradient quartiles (with the reference's exclude-exact-zeros quirk,
   :387-403), GSSIM, LPIPS (NaN when no VGG weights are available offline),
   RMSE of 4-direction Sobel gradient magnitudes (:412-437);
7. aggregate mean/std/10%/Q1/median/Q3/90% rows into performances.csv
   (:506-525 layout).

The pkl metadata (rasterio CRS/Affine objects) is decoded without rasterio by
a stub unpickler that captures the pickled constructor state.

As in the JAX package, all of it is numpy on the host. What runs on the
card is the caller's ``sr_fn``, LPIPS (``eval.lpips``) and, with
``device_metrics=True``, the batched metric block (``eval.device_metrics``)
on ``run_evaluation``'s ``device``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.eval.lpips import LPIPS
from sifsr_tpu_torch.eval.metrics import gssim_np, psnr_np, ssim_np
from sifsr_tpu_torch.geo import projection as prj
from sifsr_tpu_torch.geo.tiff import read_geotiff
from sifsr_tpu_torch.geo.warp import (
    bilinear_sample,
    bounds_of,
    suggested_warp_grid,
    warp_sinusoidal_to_utm,
)
from sifsr_tpu_torch.ops.psf import lowpass_matrix

__all__ = ["TestPair", "load_test_pair", "evaluate_pair", "compute_pair_metrics",
           "save_pair_figure", "run_evaluation", "METRIC_COLUMNS"]

METRIC_COLUMNS = (
    "PSNR",
    "SSIM",
    "RMSE",
    "RMSE (low grad per image)",
    "RMSE (mean grad per image)",
    "RMSE (high grad per image)",
    "GSSIM",
    "LPIPS",
    "RMSE_grad",
)


class _Stub:
    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.newargs = args
        return obj

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _StubUnpickler(pickle.Unpickler):
    """Unpickle rasterio/affine-bearing dicts without those libraries."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


@dataclasses.dataclass
class TestPair:
    lst: np.ndarray          # (64, 64) Kelvin
    ndvi: np.ndarray         # (256, 256)
    center: tuple[int, int]  # position in the 4800x4800 NDVI-resolution canvas
    utm_epsg: int
    granule_gt: tuple        # GDAL geotransform of the 4800x4800 SR canvas
    aster_angle: float


def load_test_pair(pkl_path: str) -> TestPair:
    with open(pkl_path, "rb") as f:
        d = _StubUnpickler(f).load()
    affine_sr = getattr(d["transform affine SR"], "newargs")  # rasterio Affine(a,b,c,d,e,f)
    a, b, c, dd, e, f = affine_sr[:6]
    return TestPair(
        lst=np.asarray(d["LST"], np.float64),
        ndvi=np.asarray(d["NDVI"], np.float64),
        center=tuple(d["center_ndvi"]),
        utm_epsg=int(str(d["to CRS"]).split(":")[1]),
        granule_gt=(c, a, b, f, dd, e),
        aster_angle=float(d["aster_angle"]),
    )


def _find_corners(image: np.ndarray, threshold: float):
    """Corners of the valid (rotated-rectangle) footprint -> inner rectangle.

    Same contract as reference utils.find_corners (utils.py:121-159): returns
    p1 = the middle two sorted corner x's, p2 = the middle two sorted corner
    y's. The reference detects the 4 corners with cv2.goodFeaturesToTrack,
    which is fragile on resampled staircase edges; for a convex footprint the
    corners are exactly the extreme points of the mask (argmin/argmax of x
    and y), which is what we use — deterministic and subpixel-robust.
    """
    mask = image >= threshold
    if not mask.any():
        return None, None
    ys, xs = np.nonzero(mask)
    corner_ids = [np.argmin(xs), np.argmax(xs), np.argmin(ys), np.argmax(ys)]
    pts = np.stack([[xs[i], ys[i]] for i in corner_ids])
    e0 = np.sort(pts[:, 0])
    e1 = np.sort(pts[:, 1])
    p1 = [int(e0[1]), int(e0[2])]
    p2 = [int(e1[1]), int(e1[2])]
    if p1[1] - p1[0] < 2 or p2[1] - p2[0] < 2:
        return None, None
    return p1, p2


def _find_corners_reference(image: np.ndarray, threshold: float):
    """Verbatim port of reference utils.find_corners (utils.py:121-159):
    binarise at `threshold`, detect the 4 footprint corners with
    cv2.goodFeaturesToTrack, return (p1 = middle two sorted x's, p2 = middle
    two sorted y's). Used by the --crop reference eval mode to reproduce the
    published notebook numbers bit-for-bit (cell 18 anchors)."""
    import cv2

    img = image.copy()
    img[img < threshold] = 0.0
    img[img >= threshold] = 1.0
    img8 = img.astype("uint8")
    gray = cv2.cvtColor(cv2.cvtColor(255 * img8, cv2.COLOR_GRAY2BGR),
                        cv2.COLOR_BGR2GRAY)
    edges = cv2.goodFeaturesToTrack(gray, 4, 0.01, 10)
    if edges is None:
        return None, None
    edges = np.intp(edges)
    if edges.shape != (4, 1, 2):
        return None, None
    edges = edges.reshape(4, 2)
    e0 = np.sort(edges[:, 0])
    e1 = np.sort(edges[:, 1])
    return [int(e0[1]), int(e0[2])], [int(e1[1]), int(e1[2])]


def _reference_crop_slices(overlap_sr, overlap_aster, min_overlap: int = 40):
    """The reference's exact common-area crop (model_perf_aster_formatds.py
    :360-369): corner-detect both footprints with the 200 K / 230 K
    thresholds (NO ramp erosion — the bilinear edge ramps above threshold
    stay in, as in the published numbers), inner-rectangle with the +-1
    shrink, then the script's verbatim -1-offset slices.

    cv2.goodFeaturesToTrack is tried verbatim first; current cv2 (5.x)
    sometimes returns a degenerate corner cluster on footprints clipped by
    the overlap window (the reference's cv2 era did not), in which case the
    deterministic extreme-point corners of the same thresholded mask are
    used — identical p1/p2 semantics, same rectangle arithmetic.
    Returns (row_slice, col_slice) or None."""

    def corners(img, thr):
        p1, p2 = _find_corners_reference(img, thr)
        if (p1 is None or p1[1] - p1[0] <= min_overlap
                or p2[1] - p2[0] <= min_overlap):
            return _find_corners(img, thr)
        return p1, p2

    p1_a, p2_a = corners(overlap_aster, 230.0)
    p1_m, p2_m = corners(overlap_sr, 200.0)
    if p1_a is None or p1_m is None:
        return None
    p1 = (max(p1_m[0], p1_a[0]) + 1, min(p1_m[1], p1_a[1]) - 1)
    p2 = (max(p2_m[0], p2_a[0]) + 1, min(p2_m[1], p2_a[1]) - 1)
    return slice(p2[0] - 1, p2[1] - 1), slice(p1[0] - 1, p1[1] - 1)


def _evaluate_pair_reference(
    pair: TestPair,
    aster_path: str,
    lst_sr: np.ndarray,
    lpips_metric: LPIPS | None = None,
    min_overlap: int = 40,
    return_crops: bool = False,
    skip_metrics: bool = False,
):
    """The reference script's eval geometry, reproduced end-to-end
    (model_perf_aster_formatds.py:253-369):

    1. the SR patch is embedded in the FULL 4800x4800 sinusoidal canvas and
       gdalwarp'd with GDAL's default suggested output grid (full-granule
       origin + extent-fitted pixel sizes — geo.warp.suggested_warp_grid),
       not a window-local grid; only the patch neighbourhood is actually
       computed (everything else is zero either way);
    2. the common window is the ASTER/granule bounds intersection read with
       rasterio windows: float offsets from from_bounds, floored to the int
       grid as rasterio's DatasetReader.read does;
    3. ASTER is read decimated onto out_shape = int(window * pixel ratio)
       with GDAL's RasterIO bilinear convention (source sample at
       (i+0.5)*ratio - 0.5 from the *rounded* window origin);
    4. the 200 K/230 K corner crop with the script's verbatim slices.

    The net sub-pixel phases of (1)-(3) are what the published cell-18
    anchors (PSNR 22.25 / SSIM 0.69 / RMSE 1.95 / RMSE_grad 6.96) encode.
    """
    cy, cx = pair.center
    gt = pair.granule_gt
    epsg = pair.utm_epsg

    full_gt, full_shape = suggested_warp_grid((4800, 4800), gt, epsg)

    # source window around the patch (the rest of the canvas is zero)
    margin = 32
    y0, x0 = cy - 128 - margin, cx - 128 - margin
    canvas_sr = np.zeros((256 + 2 * margin, 256 + 2 * margin))
    canvas_sr[margin : margin + 256, margin : margin + 256] = lst_sr
    window_gt = (gt[0] + x0 * gt[1], gt[1], 0.0, gt[3] + y0 * gt[5], 0.0, gt[5])

    # dst sub-grid (on the full grid's integer lattice) covering the window
    ts = np.linspace(0, 1, 21)
    hs = 256 + 2 * margin
    ec = np.concatenate([ts * hs, np.full(21, hs), ts[::-1] * hs, np.zeros(21)])
    er = np.concatenate([np.zeros(21), ts * hs, np.full(21, hs), ts[::-1] * hs])
    wex, wny = prj.sinusoidal_to_utm(
        window_gt[0] + ec * window_gt[1], window_gt[3] + er * window_gt[5], epsg
    )
    c0f = max(0, int(np.floor((wex.min() - full_gt[0]) / full_gt[1])) - 2)
    c1f = min(full_shape[1], int(np.ceil((wex.max() - full_gt[0]) / full_gt[1])) + 2)
    r0f = max(0, int(np.floor((wny.max() - full_gt[3]) / full_gt[5])) - 2)
    r1f = min(full_shape[0], int(np.ceil((wny.min() - full_gt[3]) / full_gt[5])) + 2)
    sub_gt = (
        full_gt[0] + c0f * full_gt[1], full_gt[1], 0.0,
        full_gt[3] + r0f * full_gt[5], 0.0, full_gt[5],
    )
    warped_sr = warp_sinusoidal_to_utm(
        canvas_sr, window_gt, epsg, dst_gt=sub_gt, dst_shape=(r1f - r0f, c1f - c0f)
    )

    aster = read_geotiff(aster_path)
    aster_img = aster.array.astype(np.float64)
    aster_gt = aster.geotransform

    # bounds intersection: FULL warped canvas vs the ASTER raster (:340-344)
    sr_b = bounds_of(full_shape, full_gt)
    as_b = bounds_of(aster_img.shape, aster_gt)
    left = max(sr_b[0], as_b[0])
    bottom = max(sr_b[1], as_b[1])
    right = min(sr_b[2], as_b[2])
    top = min(sr_b[3], as_b[3])
    if right <= left or top <= bottom:
        return None

    # win2: the intersection window on the warped-SR grid, rasterio-rounded
    # (float offsets floored, lengths rounded — rasterio windows semantics)
    c_off = (left - full_gt[0]) / full_gt[1]
    r_off = (top - full_gt[3]) / full_gt[5]
    w2 = (right - left) / full_gt[1]
    h2 = (bottom - top) / full_gt[5]
    c2i, r2i = int(np.floor(c_off)), int(np.floor(r_off))
    w2i, h2i = int(round(w2)), int(round(h2))
    overlap_sr = np.zeros((h2i, w2i))
    # place the computed sub-window into the win2 frame
    rr0 = r0f - r2i
    cc0 = c0f - c2i
    src = warped_sr.array.astype(np.float64)
    rs0, cs0 = max(0, rr0), max(0, cc0)
    rs1 = min(h2i, rr0 + src.shape[0])
    cs1 = min(w2i, cc0 + src.shape[1])
    if rs1 > rs0 and cs1 > cs0:
        overlap_sr[rs0:rs1, cs0:cs1] = src[
            rs0 - rr0 : rs1 - rr0, cs0 - cc0 : cs1 - cc0
        ]

    # win1: the intersection window on the ASTER grid + decimated bilinear
    # read onto int(window * scale) (:329-352)
    x_scale = aster_gt[1] / full_gt[1]
    y_scale = aster_gt[5] / full_gt[5]
    ac_off = (left - aster_gt[0]) / aster_gt[1]
    ar_off = (top - aster_gt[3]) / aster_gt[5]
    w1 = (right - left) / aster_gt[1]
    h1 = (bottom - top) / aster_gt[5]
    c1i, r1i = int(np.floor(ac_off)), int(np.floor(ar_off))
    w1i, h1i = int(round(w1)), int(round(h1))
    ow1 = int(w1i * x_scale)
    oh1 = int(h1i * y_scale)
    if ow1 <= min_overlap or oh1 <= min_overlap:
        return None
    jj, ii = np.meshgrid(np.arange(ow1), np.arange(oh1))
    a_cols = c1i + (jj + 0.5) * (w1i / ow1) - 0.5
    a_rows = r1i + (ii + 0.5) * (h1i / oh1) - 0.5
    overlap_aster = bilinear_sample(aster_img, a_rows, a_cols, fill=0.0) * 0.1

    sl = _reference_crop_slices(overlap_sr, overlap_aster, min_overlap)
    if sl is None:
        return None
    r_sl, c_sl = sl
    crop_aster = overlap_aster[r_sl, c_sl]
    crop_sr = overlap_sr[r_sl, c_sl]
    if (crop_aster.shape[0] <= min_overlap or crop_aster.shape[1] <= min_overlap
            or crop_sr.shape != crop_aster.shape):
        return None
    if skip_metrics and not return_crops:
        return {"LST_SR": crop_sr, "LST_ASTER": crop_aster}
    metrics = None if skip_metrics else compute_pair_metrics(
        crop_sr, crop_aster, lpips_metric)
    if not return_crops:
        return metrics

    def warp_aux(patch):
        canvas = np.zeros_like(canvas_sr)
        canvas[margin : margin + 256, margin : margin + 256] = patch
        warped = warp_sinusoidal_to_utm(
            canvas, window_gt, epsg, dst_gt=sub_gt,
            dst_shape=(r1f - r0f, c1f - c0f),
        ).array.astype(np.float64)
        frame = np.zeros((h2i, w2i))
        if rs1 > rs0 and cs1 > cs0:
            frame[rs0:rs1, cs0:cs1] = warped[
                rs0 - rr0 : rs1 - rr0, cs0 - cc0 : cs1 - cc0
            ]
        return frame[r_sl, c_sl]

    return metrics, {
        "LST:": warp_aux(np.repeat(np.repeat(pair.lst, 4, 0), 4, 1)),
        "NDVI": warp_aux(pair.ndvi),
        "LST_ASTER": crop_aster,
        "LST_SR": crop_sr,
    }


def _nonzero_rmse(sq_err: np.ndarray) -> float:
    """sqrt(mean of entries), excluding exact zeros — reference quirk
    (model_perf_aster_formatds.py:389, filter((0.0).__ne__, ...))."""
    vals = sq_err[sq_err != 0.0]
    return float(np.sqrt(vals.mean())) if vals.size else float("nan")


def evaluate_pair(
    pair: TestPair,
    aster_path: str,
    lst_sr: np.ndarray,
    lpips_metric: LPIPS | None = None,
    min_overlap: int = 40,
    return_crops: bool = False,
    crop_mode: str = "erosion",
    skip_metrics: bool = False,
):
    """Steps 2-6 for one pair; returns the metric dict (or, with
    return_crops, (metrics, crops-dict in the {idx}_dict_pred.pkl layout of
    model_perf_aster_formatds.py:499-503)) or None if the common area is too
    small (reference skips overlaps <= 40 px, :371).

    skip_metrics: geometry only — returns the crops dict (full layout with
    return_crops, else just {'LST_SR', 'LST_ASTER'}) so run_evaluation's
    batched on-device metric path (eval.device_metrics) can score every
    pair in one batched call instead of per-pair host numpy.

    crop_mode: 'erosion' (default) kills the bilinear edge ramps before the
    corner crop (tighter, ramp-free common area); 'reference' reproduces the
    reference script's whole eval geometry verbatim (gdalwarp suggested
    output grid, rasterio window reads, 200 K/230 K corner crop, -1-offset
    slices) for anchor-number parity — see _evaluate_pair_reference."""
    if crop_mode == "reference":
        return _evaluate_pair_reference(
            pair, aster_path, lst_sr, lpips_metric, min_overlap, return_crops,
            skip_metrics=skip_metrics,
        )
    cy, cx = pair.center

    # The reference embeds the patch into the full 4800x4800 granule canvas
    # and warps all of it (:253-317); everything outside the patch is zero, so
    # we warp only a margin-padded window around the patch — identical result,
    # ~200x less projection math.
    margin = 32
    y0, x0 = cy - 128 - margin, cx - 128 - margin
    canvas_sr = np.zeros((256 + 2 * margin, 256 + 2 * margin))
    canvas_sr[margin : margin + 256, margin : margin + 256] = lst_sr
    gt = pair.granule_gt
    window_gt = (gt[0] + x0 * gt[1], gt[1], 0.0, gt[3] + y0 * gt[5], 0.0, gt[5])

    warped_sr = warp_sinusoidal_to_utm(canvas_sr, window_gt, pair.utm_epsg)

    warped_lo = warped_nd = None
    if return_crops:
        # NN-upsampled input LST and the NDVI, warped on the same grid
        # (reference overlap_3 / overlap_4, :253-261,323-324)
        lst_low = np.repeat(np.repeat(pair.lst, 4, 0), 4, 1)
        canvas_lo = np.zeros_like(canvas_sr)
        canvas_lo[margin : margin + 256, margin : margin + 256] = lst_low
        canvas_nd = np.zeros_like(canvas_sr)
        canvas_nd[margin : margin + 256, margin : margin + 256] = pair.ndvi
        warped_lo = warp_sinusoidal_to_utm(
            canvas_lo, window_gt, pair.utm_epsg,
            dst_gt=warped_sr.geotransform, dst_shape=warped_sr.array.shape,
        )
        warped_nd = warp_sinusoidal_to_utm(
            canvas_nd, window_gt, pair.utm_epsg,
            dst_gt=warped_sr.geotransform, dst_shape=warped_sr.array.shape,
        )

    aster = read_geotiff(aster_path)
    aster_img = aster.array.astype(np.float64)
    aster_gt = aster.geotransform

    # bounds intersection in UTM
    sr_b = bounds_of(warped_sr.array.shape, warped_sr.geotransform)
    as_b = bounds_of(aster_img.shape, aster_gt)
    left = max(sr_b[0], as_b[0])
    bottom = max(sr_b[1], as_b[1])
    right = min(sr_b[2], as_b[2])
    top = min(sr_b[3], as_b[3])
    if right <= left or top <= bottom:
        return None

    # common window on the warped-SR grid
    gt2 = warped_sr.geotransform
    c0 = int(round((left - gt2[0]) / gt2[1]))
    c1 = int(round((right - gt2[0]) / gt2[1]))
    r0 = int(round((top - gt2[3]) / gt2[5]))
    r1 = int(round((bottom - gt2[3]) / gt2[5]))
    overlap_sr = warped_sr.array[r0:r1, c0:c1].astype(np.float64)
    oh, ow = overlap_sr.shape
    if oh <= min_overlap or ow <= min_overlap:
        return None

    # resample ASTER bilinearly onto the same UTM window/grid (:346-352)
    jj, ii = np.meshgrid(np.arange(ow), np.arange(oh))
    ux = gt2[0] + (c0 + jj + 0.5) * gt2[1]
    uy = gt2[3] + (r0 + ii + 0.5) * gt2[5]
    ac = (ux - aster_gt[0]) / aster_gt[1] - 0.5
    ar = (uy - aster_gt[3]) / aster_gt[5] - 0.5
    overlap_aster = bilinear_sample(aster_img, ar, ac, fill=0.0) * 0.1  # DN -> K

    # Crop to the common valid region. The reference crops to the inner
    # rectangle of the detected footprint corners (:360-369); bilinear
    # resampling produces ramp pixels (values blended towards 0) along both
    # footprints' borders, which the reference's 200 K threshold lets through.
    # We erode both validity masks to kill the ramps, take the inner rectangle
    # of the joint footprint's corner extremes (same construction as
    # utils.find_corners), then trim any remaining invalid border rows/cols.
    from scipy.ndimage import binary_erosion

    valid = binary_erosion(overlap_sr >= 200.0, iterations=3) & binary_erosion(
        overlap_aster >= 200.0, iterations=3
    )
    p1, p2 = _find_corners(valid.astype(np.float64), 0.5)
    if p1 is None:
        return None
    r0c, r1c = p2[0] + 1, p2[1] - 1
    c0c, c1c = p1[0] + 1, p1[1] - 1
    # trim edges still containing invalid pixels (max 25 passes)
    for _ in range(25):
        if r1c - r0c <= min_overlap or c1c - c0c <= min_overlap:
            break
        sub = valid[r0c:r1c, c0c:c1c]
        if sub.all():
            break
        edges = {
            "top": (~sub[0]).sum(),
            "bottom": (~sub[-1]).sum(),
            "left": (~sub[:, 0]).sum(),
            "right": (~sub[:, -1]).sum(),
        }
        worst = max(edges, key=edges.get)
        if edges[worst] == 0:
            # invalid pixels strictly interior (nodata holes) — accept them
            break
        if worst == "top":
            r0c += 1
        elif worst == "bottom":
            r1c -= 1
        elif worst == "left":
            c0c += 1
        else:
            c1c -= 1

    crop_aster = overlap_aster[r0c:r1c, c0c:c1c]
    crop_sr = overlap_sr[r0c:r1c, c0c:c1c]
    if crop_aster.shape[0] <= min_overlap or crop_aster.shape[1] <= min_overlap:
        return None

    if skip_metrics and not return_crops:
        return {"LST_SR": crop_sr, "LST_ASTER": crop_aster}
    metrics = None if skip_metrics else compute_pair_metrics(
        crop_sr, crop_aster, lpips_metric)
    if not return_crops:
        return metrics
    crops = {
        # reference's dict layout incl. its 'LST:' key typo, which
        # compare_methods.py:642 explicitly depends on
        "LST:": warped_lo.array[r0:r1, c0:c1][r0c:r1c, c0c:c1c].astype(np.float64),
        "NDVI": warped_nd.array[r0:r1, c0:c1][r0c:r1c, c0c:c1c].astype(np.float64),
        "LST_ASTER": crop_aster,
        "LST_SR": crop_sr,
    }
    return metrics, crops


def compute_pair_metrics(
    crop_sr: np.ndarray, crop_aster: np.ndarray, lpips_metric: LPIPS | None = None
) -> dict:
    """Step 6: the reference's metric block (:371-438) on a cropped pair."""
    import scipy.signal as sps

    maxi = max(crop_aster.max(), crop_sr.max())
    mini = min(crop_aster.min(), crop_sr.min())
    data_range = maxi - mini

    # ASTER high-frequency magnitude = |x - PSF lowpass| (get_output_ftm
    # defaults factor=4 mtf=0.1, :377-378); per-axis matrix application
    mat = lowpass_matrix(crop_aster.shape[0], 4, 0.1)
    mat2 = lowpass_matrix(crop_aster.shape[1], 4, 0.1)
    low = mat @ crop_aster @ mat2.T
    grad_aster = np.abs(crop_aster - low)

    sq = (crop_aster - crop_sr) ** 2
    lo = np.percentile(grad_aster, 25)
    hi = np.percentile(grad_aster, 75)

    err_low = sq.copy()
    err_low[grad_aster >= lo] = 0
    err_mid = sq.copy()
    err_mid[(grad_aster < lo) | (grad_aster > hi)] = 0
    err_high = sq.copy()
    err_high[grad_aster < hi] = 0

    # 4-direction Sobel gradient-magnitude RMSE (true convolution, :412-425)
    sobels = [
        [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
        [[1, 0, -1], [2, 0, -2], [1, 0, -1]],
        [[2, 1, 0], [1, 0, -1], [0, -1, -2]],
        [[0, 1, 2], [-1, 0, 1], [-2, -1, 0]],
    ]
    g_m = [sps.convolve2d(crop_sr, s, mode="valid") for s in sobels]
    g_a = [sps.convolve2d(crop_aster, s, mode="valid") for s in sobels]
    mag_m = np.sqrt(sum(g * g for g in g_m))
    mag_a = np.sqrt(sum(g * g for g in g_a))

    lp = float("nan")
    if lpips_metric is not None:
        lp = lpips_metric(
            (crop_sr - mini) / (maxi - mini), (crop_aster - mini) / (maxi - mini)
        )

    # numpy metric paths: the crops have a different shape per pair
    # (eval.device_metrics batches them padded)
    return {
        "PSNR": psnr_np(crop_sr, crop_aster, data_range),
        "SSIM": ssim_np(crop_sr, crop_aster, data_range),
        "RMSE": float(np.sqrt(sq.mean())),
        "RMSE (low grad per image)": _nonzero_rmse(err_low),
        "RMSE (mean grad per image)": _nonzero_rmse(err_mid),
        "RMSE (high grad per image)": _nonzero_rmse(err_high),
        "GSSIM": gssim_np(crop_sr, crop_aster, data_range),
        "LPIPS": lp,
        "RMSE_grad": float(np.sqrt(np.mean((mag_m - mag_a) ** 2))),
    }


def save_pair_figure(crops: dict, path: str) -> None:
    """4-panel comparison figure per pair (LST / NDVI / SR / ASTER), the
    layout of model_perf_aster_formatds.py:469-496."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mini = min(crops["LST_ASTER"].min(), crops["LST_SR"].min())
    maxi = max(crops["LST_ASTER"].max(), crops["LST_SR"].max())
    fig, axes = plt.subplots(2, 2, figsize=(14, 12))
    panels = [
        ("LST MODIS", crops["LST:"], "jet", (mini, maxi)),
        ("NDVI", crops["NDVI"], "RdYlGn", (None, None)),
        ("MODIS LST SR", crops["LST_SR"], "jet", (mini, maxi)),
        ("ASTER LST", crops["LST_ASTER"], "jet", (mini, maxi)),
    ]
    for ax, (title, img, cmap, (vmin, vmax)) in zip(axes.ravel(), panels):
        im = ax.imshow(img, cmap=cmap, aspect="auto", vmin=vmin, vmax=vmax)
        fig.colorbar(im, ax=ax)
        ax.set_title(title)
    fig.savefig(path, dpi=80, bbox_inches="tight")
    plt.close(fig)


def run_evaluation(
    dataset_dir: str,
    sr_fn,
    output_csv: str | None = None,
    lpips_metric: LPIPS | None = None,
    limit: int | None = None,
    save_pairs_dir: str | None = None,
    figures_dir: str | None = None,
    log_fn=print,
    crop_mode: str = "erosion",
    device_metrics: bool = False,
    device: str = "cuda",
) -> "object":
    """Evaluate ``sr_fn(lst (64,64) K, ndvi (256,256)) -> (256,256) K`` over
    the whole formatted test set; returns the pandas results frame and
    optionally writes the reference-layout performances.csv. With
    save_pairs_dir, each pair's cropped arrays are pickled as
    {idx}_dict_pred.pkl for the compare_methods spectral batch job.

    device_metrics=True scores every pair's metric block in ONE batched
    call on ``device`` after the crop loop (eval.device_metrics: padded/
    masked batch over the variable-shape crops) instead of per-pair host
    numpy; per-pair values match the numpy path within 2e-4
    (tests/test_torch_device_metrics.py). LPIPS (weights-gated) stays
    per-pair, on its own device, either way. ``device`` defaults to the
    card and raises without one; pass 'cpu' to run the block there."""
    import pandas as pd

    dev = resolve_device(device)

    if save_pairs_dir:
        os.makedirs(save_pairs_dir, exist_ok=True)
    manifest = pd.read_csv(os.path.join(dataset_dir, "dataset.csv"))
    rows = {}
    count = 0
    for _, row in manifest.iterrows():
        idx = row.iloc[0]
        aster_path = os.path.join(dataset_dir, "data", os.path.basename(row["Aster 250m UTM"]))
        pkl_path = os.path.join(dataset_dir, "data", os.path.basename(row["MODIS patch"]))
        pair = load_test_pair(pkl_path)
        if pair.ndvi.shape != (256, 256):
            continue
        lst_sr = sr_fn(pair.lst, pair.ndvi)
        want_crops = bool(save_pairs_dir or figures_dir)
        result = evaluate_pair(
            pair, aster_path, lst_sr, lpips_metric, return_crops=want_crops,
            crop_mode=crop_mode, skip_metrics=device_metrics,
        )
        if result is None:
            log_fn(f"pair {idx}: skipped (no usable overlap)")
            continue
        if device_metrics:
            crops = result[1] if want_crops else result
        elif want_crops:
            metrics, crops = result
        else:
            metrics, crops = result, None
        if want_crops:
            if save_pairs_dir:
                with open(os.path.join(save_pairs_dir, f"{idx}_dict_pred.pkl"), "wb") as f:
                    pickle.dump(crops, f)
            if figures_dir:
                os.makedirs(figures_dir, exist_ok=True)
                save_pair_figure(crops, os.path.join(figures_dir, f"{idx}_predictions_cropped.png"))
        if device_metrics:
            # LPIPS stays host-side (same normalisation as
            # compute_pair_metrics); the 8 device columns land after the loop
            lp = float("nan")
            crop_sr, crop_aster = crops["LST_SR"], crops["LST_ASTER"]
            if lpips_metric is not None:
                maxi = max(crop_aster.max(), crop_sr.max())
                mini = min(crop_aster.min(), crop_sr.min())
                lp = lpips_metric((crop_sr - mini) / (maxi - mini),
                                  (crop_aster - mini) / (maxi - mini))
            rows[idx] = {"LPIPS": lp, "_crops": (crop_sr, crop_aster)}
            log_fn(f"pair {idx}: cropped {crop_sr.shape} (metrics batched)")
        else:
            rows[idx] = metrics
            log_fn(f"pair {idx}: " + "  ".join(f"{k}={v:.3f}" for k, v in metrics.items()))
        count += 1
        if limit is not None and count >= limit:
            break

    if device_metrics and rows:
        from sifsr_tpu_torch.eval.device_metrics import device_metric_rows

        order = list(rows)
        mrows = device_metric_rows([rows[i]["_crops"] for i in order], dev)
        for idx, mr in zip(order, mrows):
            mr["LPIPS"] = rows[idx]["LPIPS"]
            rows[idx] = mr
            log_fn(f"pair {idx}: " + "  ".join(
                f"{k}={v:.3f}" for k, v in mr.items()))

    df = pd.DataFrame.from_dict(rows, orient="index", columns=list(METRIC_COLUMNS))
    base = df.copy()
    df.loc["mean"] = base.mean()
    df.loc["std"] = base.std()
    df.loc["10%"] = base.quantile(0.1)
    df.loc["Q1"] = base.quantile(0.25)
    df.loc["mediane"] = base.quantile(0.5)
    df.loc["Q3"] = base.quantile(0.75)
    df.loc["90%"] = base.quantile(0.9)
    if output_csv:
        os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
        df.to_csv(output_csv)
    return df
