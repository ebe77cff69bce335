"""The port's own copies of the host-side geo and ingest modules give the
same outputs as the JAX package's modules on the same inputs (identical:
both are numpy code, copied)."""

import numpy as np
import pytest

from sifsr_tpu.data import ingest as jax_ingest
from sifsr_tpu.geo import hdf4 as jax_hdf4
from sifsr_tpu.geo import projection as jax_prj
from sifsr_tpu.geo import warp as jax_warp
from sifsr_tpu.geo.tiff import GeoTiff as JaxGeoTiff

from sifsr_tpu_torch.data import ingest
from sifsr_tpu_torch.geo import hdf4, projection, warp
from sifsr_tpu_torch.geo.tiff import GeoTiff

STRUCT_META = """GROUP=GridStructure
\tXDim=96
\tYDim=64
\tUpperLeftPointMtrs=(0.000000,5559752.598333)
\tLowerRightMtrs=(88956.041,5500448.570)
END_GROUP=GridStructure
"""


@pytest.mark.parametrize("deflate", [False, True])
def test_hdf4_files_and_readers_identical(tmp_path, rng, deflate):
    """write_hdf4_sds writes the same bytes; each package reads the other's
    file to the same arrays and geotransform (LST and Red/NIR readers)."""
    lst_dn = (rng.random((64, 96)) * 1500 + 14500).astype(np.uint16)
    qc = rng.integers(0, 4, (64, 96)).astype(np.uint8)
    red = (rng.random((64, 96)) * 3000).astype(np.int16)
    nir = (rng.random((64, 96)) * 6000).astype(np.int16)
    paths = {}
    for name, mod in (("port", hdf4), ("jax", jax_hdf4)):
        paths[name] = (str(tmp_path / f"{name}_lst.hdf"), str(tmp_path / f"{name}_refl.hdf"))
        mod.write_hdf4_sds(paths[name][0], {"LST_Day_1KM": lst_dn, "QC_Day": qc},
                           struct_metadata=STRUCT_META, deflate=deflate)
        mod.write_hdf4_sds(paths[name][1], {"sur_refl_b01_1": red, "sur_refl_b02_1": nir},
                           struct_metadata=STRUCT_META, deflate=deflate)
    for a, b in zip(paths["port"], paths["jax"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    got_lst, got_qc, got_gt = hdf4.read_modis_lst(paths["jax"][0], with_qc=True)
    want_lst, want_qc, want_gt = jax_hdf4.read_modis_lst(paths["port"][0], with_qc=True)
    np.testing.assert_array_equal(got_lst, want_lst)
    np.testing.assert_array_equal(got_qc, want_qc)
    assert got_gt == want_gt and got_gt is not None
    np.testing.assert_array_equal(got_lst, lst_dn.astype(np.float32) * np.float32(0.02))
    for g, w in zip(hdf4.read_modis_nir_red(paths["jax"][1]),
                    jax_hdf4.read_modis_nir_red(paths["port"][1])):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    with pytest.raises(hdf4.HDF4Error):
        bad = tmp_path / "bad.hdf"
        bad.write_bytes(b"not an hdf file at all")
        hdf4.HDF4File(str(bad))


def test_projection_identical(rng):
    lon = rng.uniform(-10.0, 30.0, 200)
    lat = rng.uniform(35.0, 60.0, 200)
    epsg = 32632
    x, y = projection.lonlat_to_sinusoidal(lon, lat)
    jx, jy = jax_prj.lonlat_to_sinusoidal(lon, lat)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    for g, w in zip(projection.sinusoidal_to_lonlat(x, y), jax_prj.sinusoidal_to_lonlat(x, y)):
        np.testing.assert_array_equal(g, w)
    e, n = projection.lonlat_to_utm(lon, lat, epsg)
    je, jn = jax_prj.lonlat_to_utm(lon, lat, epsg)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(n, jn)
    for g, w in zip(projection.utm_to_lonlat(e, n, epsg), jax_prj.utm_to_lonlat(e, n, epsg)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(projection.sinusoidal_to_utm(x, y, epsg),
                    jax_prj.sinusoidal_to_utm(x, y, epsg)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(projection.utm_to_sinusoidal(e, n, epsg),
                    jax_prj.utm_to_sinusoidal(e, n, epsg)):
        np.testing.assert_array_equal(g, w)
    assert projection.utm_epsg_info(32733) == jax_prj.utm_epsg_info(32733)
    # a round trip closes within 1e-6 degrees (0.1 m), far below a 231 m pixel
    back = projection.utm_to_lonlat(e, n, epsg)
    assert np.abs(back[0] - lon).max() < 1e-6 and np.abs(back[1] - lat).max() < 1e-6


def test_warp_identical(rng):
    """A sinusoidal raster warped to UTM: same grid, same samples."""
    arr = rng.random((40, 50)).astype(np.float32)
    x0, y0 = jax_prj.lonlat_to_sinusoidal(np.asarray(10.0), np.asarray(48.0))
    gt = (float(x0), 926.6, 0.0, float(y0), 0.0, -926.6)
    got = warp.warp_sinusoidal_to_utm(arr, gt, 32632)
    want = jax_warp.warp_sinusoidal_to_utm(arr, gt, 32632)
    assert isinstance(got, GeoTiff) and isinstance(want, JaxGeoTiff)
    assert got.geotransform == want.geotransform and got.array.shape == want.array.shape
    np.testing.assert_array_equal(got.array, want.array)
    assert (got.array > 0).mean() > 0.5
    assert warp.suggested_warp_grid.__doc__ == jax_warp.suggested_warp_grid.__doc__
    np.testing.assert_array_equal(
        warp.bilinear_sample(arr, np.asarray([[0.5, 3.2]]), np.asarray([[1.5, 60.0]])),
        jax_warp.bilinear_sample(arr, np.asarray([[0.5, 3.2]]), np.asarray([[1.5, 60.0]])))


def test_ingest_identical(rng):
    nir = rng.random((128, 128)).astype(np.float32)
    red = rng.random((128, 128)).astype(np.float32)
    np.testing.assert_array_equal(ingest.compute_ndvi(nir, red), jax_ingest.compute_ndvi(nir, red))
    lst = (290.0 + 20.0 * rng.random((128, 192))).astype(np.float32)
    lst[:10, :10] = 0.0
    qc = rng.integers(0, 4, (128, 192)).astype(np.uint8)
    gt = (0.0, 926.6, 0.0, 5559752.6, 0.0, -926.6)
    got = ingest.extract_lst_patches(lst, qc, gt, coverage=0.05, check_qc_bits=False)
    want = jax_ingest.extract_lst_patches(lst, qc, gt, coverage=0.05, check_qc_bits=False)
    for field in ("patches", "block_index", "geotransforms"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert len(got.block_index) == 6          # 100 of 4096 pixels invalid: under 5 %
    mask = rng.random((40, 40)) > 0.9
    np.testing.assert_array_equal(ingest.dilate_water_mask(mask), jax_ingest.dilate_water_mask(mask))
    np.testing.assert_array_equal(ingest.qc_bad_bit(qc), jax_ingest.qc_bad_bit(qc))
