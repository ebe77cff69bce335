"""The port's ASTER evaluation harness (``sifsr_tpu_torch.eval.harness``)
against the JAX package's on synthetic pairs in the harness's own format,
written by ``chip_smoke.write_aster_pairs`` (the pairs of chip_smoke.py's
eval phase)."""

import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest

from sifsr_tpu.baselines import bicubic_sr as jax_bicubic_sr
from sifsr_tpu.eval import harness as jh

from sifsr_tpu_torch.baselines import bicubic_sr
from sifsr_tpu_torch.eval import harness as th

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
N_PAIRS = 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sys.path.insert(0, ROOT)
    from chip_smoke import write_aster_pairs

    d = str(tmp_path_factory.mktemp("aster_pairs"))
    write_aster_pairs(d, N_PAIRS, seed=5)
    return d


def _paths(dataset, i):
    data = os.path.join(dataset, "data")
    return os.path.join(data, f"{i}_data_dict.pkl"), os.path.join(data, f"{i}_aster_250m.tif")


def test_load_test_pair_equals_jax(dataset):
    """Every field of every pair, through the stub unpicklers of both
    packages (no affine or rasterio installed: the Affine's arguments come
    from NEWOBJ's newargs)."""
    for i in range(N_PAIRS):
        got, want = th.load_test_pair(_paths(dataset, i)[0]), jh.load_test_pair(_paths(dataset, i)[0])
        np.testing.assert_array_equal(got.lst, want.lst)
        np.testing.assert_array_equal(got.ndvi, want.ndvi)
        assert got.lst.shape == (64, 64) and got.ndvi.shape == (256, 256)
        assert (got.center, got.utm_epsg, got.granule_gt, got.aster_angle) == (
            want.center, want.utm_epsg, want.granule_gt, want.aster_angle)
        assert 32631 <= got.utm_epsg <= 32633 and got.granule_gt[1] > 0 > got.granule_gt[5]


@pytest.mark.parametrize("crop_mode", ["erosion", "reference"])
def test_evaluate_pair_equals_jax(dataset, crop_mode):
    """Crops (the 'LST:' layout) and metrics of both packages for the same
    lst_sr, in both crop modes: the geometry is the same numpy on both
    sides, so the crops are equal and the metrics agree to 1e-12."""
    for i in range(N_PAIRS):
        pkl, tif = _paths(dataset, i)
        pair = th.load_test_pair(pkl)
        lst_sr = bicubic_sr(pair.lst).astype(np.float64)
        got = th.evaluate_pair(pair, tif, lst_sr, return_crops=True, crop_mode=crop_mode)
        want = jh.evaluate_pair(jh.load_test_pair(pkl), tif, lst_sr, return_crops=True,
                                crop_mode=crop_mode)
        assert got is not None and want is not None
        (gm, gc), (wm, wc) = got, want
        assert set(gc) == set(wc) == {"LST:", "NDVI", "LST_ASTER", "LST_SR"}
        for k in gc:
            np.testing.assert_array_equal(gc[k], wc[k])
        assert min(gc["LST_SR"].shape) > 40     # the harness's min_overlap
        for col in th.METRIC_COLUMNS:
            np.testing.assert_allclose(gm[col], wm[col], rtol=1e-12, atol=1e-12,
                                       err_msg=col)


def test_run_evaluation_bicubic_csv_equals_jax(dataset, tmp_path):
    """run_evaluation with each package's bicubic_sr writes the same
    performances.csv (pair rows and the seven summary rows) within 1e-6,
    and pickles each pair's crops in the reference's 'LST:' layout."""
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    th.run_evaluation(dataset, lambda lst, ndvi: bicubic_sr(lst),
                      output_csv=str(out_t / "performances.csv"), save_pairs_dir=str(out_t),
                      log_fn=lambda s: None, device="cpu")
    jh.run_evaluation(dataset, lambda lst, ndvi: jax_bicubic_sr(lst),
                      output_csv=str(out_j / "performances.csv"), log_fn=lambda s: None)
    got = pd.read_csv(out_t / "performances.csv", index_col=0)
    want = pd.read_csv(out_j / "performances.csv", index_col=0)
    assert list(got.columns) == list(th.METRIC_COLUMNS)
    assert list(got.index) == list(want.index) == [str(i) for i in range(N_PAIRS)] + [
        "mean", "std", "10%", "Q1", "mediane", "Q3", "90%"]
    np.testing.assert_allclose(got.to_numpy(float), want.to_numpy(float), rtol=1e-6, atol=1e-6)
    assert got["LPIPS"].isna().all()
    for i in range(N_PAIRS):
        with open(out_t / f"{i}_dict_pred.pkl", "rb") as f:
            crops = pickle.load(f)
        assert set(crops) == {"LST:", "NDVI", "LST_ASTER", "LST_SR"}
        assert len({v.shape for v in crops.values()}) == 1
