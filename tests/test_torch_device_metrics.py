"""The port's batched metric block (``sifsr_tpu_torch.eval.device_metrics``)
against the JAX package's and against the port's per-pair host path, on the
same crops (2e-4, the bound of tests/test_device_metrics.py)."""

import os
import sys

import numpy as np
import pytest

from sifsr_tpu.eval.device_metrics import device_metric_rows as jax_device_metric_rows

from sifsr_tpu_torch.eval.device_metrics import COLUMNS, device_metric_rows, pad_crops
from sifsr_tpu_torch.eval.harness import compute_pair_metrics

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SUMMARY = ["mean", "std", "10%", "Q1", "mediane", "Q3", "90%"]


def _synthetic_crop_pairs(rng, shapes):
    """Kelvin-scale crops with structure (so SSIM/GSSIM aren't degenerate)."""
    pairs = []
    for h, w in shapes:
        yy, xx = np.mgrid[0:h, 0:w]
        base = 300.0 + 8.0 * np.sin(yy / 17.0) + 6.0 * np.cos(xx / 23.0)
        aster = base + rng.normal(0, 0.8, (h, w))
        sr = base + rng.normal(0, 0.8, (h, w)) + 0.4 * rng.random((h, w))
        pairs.append((sr.astype(np.float64), aster.astype(np.float64)))
    return pairs


def _assert_rows_match(pairs, rtol=2e-4, atol=2e-4):
    """Each pair's eight columns: the port's block on the CPU against JAX's
    block and against the port's host numpy path."""
    got = device_metric_rows(pairs, device="cpu")
    jax_rows = jax_device_metric_rows(pairs)
    for (sr, aster), row, jrow in zip(pairs, got, jax_rows):
        host = compute_pair_metrics(sr, aster)
        assert list(row) == list(COLUMNS)
        for col in COLUMNS:
            np.testing.assert_allclose(row[col], jrow[col], rtol=rtol, atol=atol,
                                       err_msg=f"{col} vs JAX on crop {sr.shape}")
            np.testing.assert_allclose(row[col], host[col], rtol=rtol, atol=atol,
                                       err_msg=f"{col} vs host on crop {sr.shape}")


def test_device_metrics_match_jax_and_host_on_variable_shapes(rng):
    """Mixed crop shapes in one padded batch: padding never leaks into
    windows, percentiles or counts."""
    _assert_rows_match(_synthetic_crop_pairs(rng, [(96, 128), (211, 97), (128, 128), (97, 211)]))


def test_stratified_rmse_nonzero_quirk_preserved():
    """The reference drops exact-zero squared errors from stratified RMSE
    (model_perf_aster_formatds.py:389): a block where pred == target."""
    rng = np.random.default_rng(7)
    (sr, aster), = _synthetic_crop_pairs(rng, [(96, 96)])
    sr[10:30, 10:30] = aster[10:30, 10:30]
    _assert_rows_match([(sr, aster)])


def test_pad_crops_layout():
    rng = np.random.default_rng(0)
    crops = [rng.random((5, 9)), rng.random((8, 4))]
    padded, shapes = pad_crops(crops)
    assert padded.shape == (2, 8, 9) and padded.dtype == np.float32
    np.testing.assert_array_equal(shapes, [[5, 9], [8, 4]])
    np.testing.assert_allclose(padded[0, :5, :9], crops[0], rtol=1e-6)
    assert padded[0, 5:].sum() == 0 and padded[1, :, 4:].sum() == 0


def test_run_evaluation_device_metrics_match_host(tmp_path):
    """run_evaluation(device_metrics=True) on synthetic ASTER pairs (the
    pairs of chip_smoke.py's eval phase) against the host path: every pair's
    eight columns within 2e-4; LPIPS NaN on both without weights."""
    from sifsr_tpu_torch.baselines import bicubic_sr
    from sifsr_tpu_torch.eval.harness import run_evaluation

    sys.path.insert(0, ROOT)
    from chip_smoke import write_aster_pairs

    write_aster_pairs(str(tmp_path), 3, seed=9)
    kw = dict(log_fn=lambda *_: None, device="cpu")
    host = run_evaluation(str(tmp_path), lambda lst, ndvi: bicubic_sr(lst), **kw)
    dev = run_evaluation(str(tmp_path), lambda lst, ndvi: bicubic_sr(lst), device_metrics=True,
                         **kw)
    base_host, base_dev = host.drop(index=SUMMARY), dev.drop(index=SUMMARY)
    assert list(base_dev.index) == list(base_host.index) and len(base_dev) == 3
    for col in COLUMNS:
        np.testing.assert_allclose(base_dev[col].to_numpy(float), base_host[col].to_numpy(float),
                                   rtol=2e-4, atol=2e-4, err_msg=col)
    assert dev["LPIPS"].isna().all()
