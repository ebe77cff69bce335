"""The port's unaligned-raster DMS (``sifsr_tpu_torch.baselines.dms_rasters``,
its regressors on the CPU here) against the JAX package's on the cases of
tests/test_dms_rasters.py: the grid resamplers give the same arrays, and
``sharpen_rasters`` the same LST within 1e-4 K."""

import numpy as np
import pytest

from sifsr_tpu.baselines import dms_rasters as jax_rasters
from sifsr_tpu.geo.projection import sinusoidal_to_utm, utm_to_sinusoidal

from sifsr_tpu_torch.baselines import dms_rasters

TOL_K = 1e-4


def _scene(rng, lh=24, lw=24, f=4):
    """Synthetic NDVI->LST scene with a known linear relationship + texture
    (tests/test_dms_rasters.py)."""
    hh, hw = lh * f, lw * f
    yy, xx = np.mgrid[0:hh, 0:hw]
    ndvi = 0.3 + 0.25 * np.sin(yy / 19.0) + 0.2 * np.cos(xx / 13.0)
    ndvi += 0.02 * rng.standard_normal((hh, hw))
    lst_hr = 310.0 - 18.0 * ndvi + 0.3 * rng.standard_normal((hh, hw))
    lst_lr = lst_hr.reshape(lh, f, lw, f).mean(axis=(1, 3))
    return ndvi, lst_hr, lst_lr


def test_grid_resamplers_equal_jax(rng):
    src = rng.random((32, 40, 2))
    src_gt = (500.0, 10.0, 0.0, 800.0, 0.0, -10.0)
    dst_gt = (493.0, 37.0, 0.0, 806.0, 0.0, -41.0)
    for got, want in zip(dms_rasters.bin_to_grid(src, src_gt, (9, 11), dst_gt),
                         jax_rasters.bin_to_grid(src, src_gt, (9, 11), dst_gt)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        dms_rasters.resample_bilinear_to_grid(src[..., 0], src_gt, (12, 14), dst_gt),
        jax_rasters.resample_bilinear_to_grid(src[..., 0], src_gt, (12, 14), dst_gt))


def _aligned(rng):
    ndvi, _, lst_lr = _scene(rng)
    return (lst_lr, (0.0, 1000.0, 0.0, 0.0, 0.0, -1000.0), ndvi,
            (0.0, 250.0, 0.0, 0.0, 0.0, -250.0), {})


def _unaligned(rng):
    ndvi, lst_hr, _ = _scene(rng)
    hr_gt = (137.0, 231.0, 0.0, -950.0, 0.0, -233.0)
    lr_gt = (0.0, 860.0, 0.0, -700.0, 0.0, -871.0)
    lh = int(ndvi.shape[0] * 233 / 871) + 1
    lw = int(ndvi.shape[1] * 231 / 860) + 1
    lst_lr, _ = jax_rasters.bin_to_grid(lst_hr, hr_gt, (lh, lw), lr_gt)
    return lst_lr, lr_gt, ndvi, hr_gt, {}


def _windows_and_crs(rng):
    ndvi, lst_hr, _ = _scene(rng, lh=16, lw=16)
    hr_gt = (300000.0, 231.65, 0.0, 4900000.0, 0.0, -231.65)
    epsg = 32631
    x0, y0 = sinusoidal_to_utm(hr_gt[0], hr_gt[3], epsg)
    lr_gt = (float(x0), 1000.0, 0.0, float(y0), 0.0, -1000.0)
    to_lr = lambda x, y: sinusoidal_to_utm(x, y, epsg)  # noqa: E731
    to_hr = lambda x, y: utm_to_sinusoidal(x, y, epsg)  # noqa: E731
    lst_lr, _ = jax_rasters.bin_to_grid(lst_hr, hr_gt, (18, 18), lr_gt, transform=to_lr)
    return lst_lr, lr_gt, ndvi, hr_gt, dict(to_lr=to_lr, to_hr=to_hr, moving_window_size=6)


@pytest.mark.parametrize("make", [_aligned, _unaligned, _windows_and_crs],
                         ids=["aligned", "unaligned", "windows-crs"])
def test_sharpen_rasters_matches_jax(rng, make):
    lst_lr, lr_gt, ndvi, hr_gt, opts = make(rng)
    want = jax_rasters.sharpen_rasters(lst_lr, lr_gt, ndvi, hr_gt, **opts)
    got = dms_rasters.sharpen_rasters(lst_lr, lr_gt, ndvi, hr_gt, device="cpu", **opts)
    assert got.shape == want.shape == ndvi.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL_K


def test_sharpen_rasters_takes_several_bands(rng):
    """(H, W, B) bands: a band that copies another ties it at every split and
    the trees split on the first (the port's rule), so without leaf ridges
    two copies give the one-band result; two different bands sharpen."""
    ndvi, lst_hr, lst_lr = _scene(rng, lh=12, lw=12)
    lr_gt = (0.0, 1000.0, 0.0, 0.0, 0.0, -1000.0)
    hr_gt = (0.0, 250.0, 0.0, 0.0, 0.0, -250.0)
    kw = dict(device="cpu", per_leaf_linear_regression=False)
    one = dms_rasters.sharpen_rasters(lst_lr, lr_gt, ndvi, hr_gt, **kw)
    two = dms_rasters.sharpen_rasters(lst_lr, lr_gt, np.stack([ndvi, ndvi], -1), hr_gt, **kw)
    np.testing.assert_array_equal(two, one)
    bands = np.stack([ndvi, np.cos(ndvi * 3.0)], -1)
    got = dms_rasters.sharpen_rasters(lst_lr, lr_gt, bands, hr_gt, device="cpu")
    assert got.shape == ndvi.shape and np.isfinite(got).all()
    assert float(np.sqrt(np.mean((got - lst_hr) ** 2))) < 1.0
