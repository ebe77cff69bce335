"""MODIS granule -> training-patch ingest (process_modis.py rebuilt).

The port's own copy of ``sifsr_tpu/data/ingest.py`` (numpy and scipy only).

The reference iterates 64x64 windows in Python, testing validity pixel-by-
pixel (process_modis.py:88-112 — including an np.unpackbits call per pixel
for the QC bit). Here the whole granule is processed as one vectorised pass:
block-reshape, mask reductions, and a boolean keep-vector; patch geotransform
updates match process_modis.py:119-121.

Traversal order parity: the reference's ``us.split`` generator
(utils.py:79-84) yields patches in column-major block order (outer loop over
columns) with a 1-based serial counter; that counter links an LST patch to
its NDVI window (process_modis.py:280-286) and ``block_index`` reproduces it
exactly.

Known reference quirk NOT reproduced: ``us.split`` yields ``(j, i)`` where
``j`` is the ROW offset, but the caller plugs it into the geotransform's
x-term (process_modis.py:119-121) — every patch geotransform has its row and
column offsets swapped. The bug is consistent between LST and NDVI (pairing
still aligns) and cancels in the georeference-error check; we write the
*correct* geotransforms here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "compute_ndvi",
    "qc_bad_bit",
    "PatchSet",
    "extract_lst_patches",
    "extract_ndvi_windows",
    "georeference_error",
    "dilate_water_mask",
]


def compute_ndvi(nir: np.ndarray, red: np.ndarray) -> np.ndarray:
    """NDVI = (NIR - Red) / (NIR + Red)  (reference utils.py:53-71)."""
    return (nir - red) / (nir + red)


def qc_bad_bit(qc: np.ndarray) -> np.ndarray:
    """MOD11A1 QC low bit (the reference reads np.unpackbits(...)[-1] per
    pixel, process_modis.py:100-104): 1 where the mandatory-QA low bit flags
    'other quality'."""
    return (qc & 1).astype(np.uint8)


@dataclasses.dataclass
class PatchSet:
    patches: np.ndarray        # (N, w, w)
    block_index: np.ndarray    # (N,) 1-based serial matching the reference counter
    geotransforms: np.ndarray  # (N, 6)


def _blockify(img: np.ndarray, window: int) -> np.ndarray:
    """Column-major (reference traversal) blocks: (n_blocks, window, window)."""
    gh, gw = img.shape[0] // window, img.shape[1] // window
    blocks = (
        img[: gh * window, : gw * window]
        .reshape(gh, window, gw, window)
        .transpose(2, 0, 1, 3)  # x-outer traversal: column of blocks first
        .reshape(gw * gh, window, window)
    )
    return blocks


def extract_lst_patches(
    lst: np.ndarray,
    qc: np.ndarray | None,
    geotransform: tuple,
    window: int = 64,
    coverage: float = 0.0,
    check_qc_bits: bool = False,
) -> PatchSet:
    """Valid 64x64 LST patches of a granule.

    A patch is kept when (bad-pixel count) <= coverage * window², where bad =
    (LST == 0 K) plus, for MOD11A1 (check_qc_bits=True), the QC low bit
    (process_modis.py:95-112; MOD21A1D skips the QC test, :170-185).
    """
    gh, gw = lst.shape[0] // window, lst.shape[1] // window
    blocks = _blockify(lst, window)
    bad = blocks == 0.0
    if check_qc_bits and qc is not None:
        bad = bad | (_blockify(qc, window) & 1).astype(bool)
    keep = bad.sum(axis=(1, 2)) <= coverage * window * window

    # geotransforms per block, traversal-ordered
    xs, ys = np.meshgrid(np.arange(gw), np.arange(gh), indexing="ij")
    x_pix = (xs * window).reshape(-1)
    y_pix = (ys * window).reshape(-1)
    gt = np.asarray(geotransform, np.float64)
    gts = np.tile(gt, (len(x_pix), 1))
    gts[:, 0] = gt[0] + x_pix * gt[1] + y_pix * gt[2]
    gts[:, 3] = gt[3] + x_pix * gt[4] + y_pix * gt[5]

    idx = np.nonzero(keep)[0]
    return PatchSet(
        patches=blocks[idx],
        block_index=idx + 1,
        geotransforms=gts[idx],
    )


def extract_ndvi_windows(
    nir: np.ndarray,
    red: np.ndarray,
    geotransform: tuple,
    block_index: np.ndarray,
    window: int = 256,
    clip: bool = True,
) -> tuple[PatchSet, np.ndarray]:
    """NDVI windows matching LST patch serial numbers
    (process_modis.py:214-335 semantics).

    Windows containing a zero NIR+Red denominator are rejected — the reference
    deletes the LST partner too (:289-296); the returned boolean mask (aligned
    with ``block_index``) says which pairs survived.
    """
    nir_b = _blockify(nir, window)
    red_b = _blockify(red, window)
    sel = np.asarray(block_index) - 1
    nir_b, red_b = nir_b[sel], red_b[sel]

    ok = ~np.any(nir_b + red_b == 0.0, axis=(1, 2))
    ndvi = compute_ndvi(nir_b[ok], red_b[ok])
    if clip:
        ndvi = np.clip(ndvi, -1.0, 1.0)

    gh, gw = nir.shape[0] // window, nir.shape[1] // window
    xs, ys = np.meshgrid(np.arange(gw), np.arange(gh), indexing="ij")
    x_pix = (xs * window).reshape(-1)[sel][ok]
    y_pix = (ys * window).reshape(-1)[sel][ok]
    gt = np.asarray(geotransform, np.float64)
    gts = np.tile(gt, (len(x_pix), 1))
    gts[:, 0] = gt[0] + x_pix * gt[1] + y_pix * gt[2]
    gts[:, 3] = gt[3] + x_pix * gt[4] + y_pix * gt[5]

    return (
        PatchSet(patches=ndvi, block_index=np.asarray(block_index)[ok], geotransforms=gts),
        ok,
    )


def georeference_error(lst_gt: np.ndarray, ndvi_gt: np.ndarray) -> float:
    """|Δx| + |Δy| of the pair origins (process_modis.py:388-425)."""
    return float(abs(lst_gt[0] - ndvi_gt[0]) + abs(lst_gt[3] - ndvi_gt[3]))


def dilate_water_mask(mask: np.ndarray, size: int = 5) -> np.ndarray:
    """5x5 binary dilation of the MOD44W water mask (process_modis.py:338-385;
    the reference uses skimage.morphology with a square element)."""
    from scipy.ndimage import binary_dilation

    return binary_dilation(mask.astype(bool), structure=np.ones((size, size), bool))
