"""The training-side ops of the port against the JAX package on the same
seeded inputs: sensor-model matrices and ops, resize, pooling, Sobel bank,
PSNR/SSIM, the seven loss functions (also against the torch goldens), batch
preparation, the GeoTIFF copy and the datasets."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.data import datasets as jax_datasets
from sifsr_tpu.eval import metrics as jax_metrics
from sifsr_tpu.geo import tiff as jax_tiff
from sifsr_tpu.losses import losses as jax_losses
from sifsr_tpu.ops import filters as jax_filters
from sifsr_tpu.ops import pooling as jax_pooling
from sifsr_tpu.ops import psf as jax_psf
from sifsr_tpu.ops import resize as jax_resize

from sifsr_tpu_torch import config as port_config
from sifsr_tpu_torch.data import datasets
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.eval import metrics
from sifsr_tpu_torch.geo import tiff
from sifsr_tpu_torch.losses import losses
from sifsr_tpu_torch.ops import filters, pooling, psf, resize

from conftest import require_golden

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
MEAN, STD = 295.0, 10.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


@pytest.mark.parametrize("deci_type,apply_psf", [("bic", True), ("bic", False),
                                                 ("norm-L4", True), ("norm-L4", False)])
@pytest.mark.parametrize("size", [64, 256])
def test_downscale_matrix_equals_jax(size, deci_type, apply_psf):
    got = psf.downscale_matrix(size, 4, 0.1, None, deci_type, apply_psf)
    want = jax_psf.downscale_matrix(size, 4, 0.1, None, deci_type, apply_psf)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_lowpass_matrix_and_psf_kernels_equal_jax():
    for size, mtf in ((64, 0.25), (256, 0.25), (256, 0.1)):
        np.testing.assert_array_equal(psf.lowpass_matrix(size, 4, mtf),
                                      jax_psf.lowpass_matrix(size, 4, mtf))
    np.testing.assert_array_equal(psf.psf_kernel_1d(1.0, 4.0, 0.1), jax_psf.psf_kernel_1d(1.0, 4.0, 0.1))
    np.testing.assert_array_equal(psf.generate_psf_kernel(1.0, 4.0, 0.1, 3),
                                  jax_psf.generate_psf_kernel(1.0, 4.0, 0.1, 3))
    with pytest.raises(ValueError, match="deci_type"):
        psf.downscale_matrix(64, deci_type="nearest")


@pytest.mark.parametrize("deci_type", ["bic", "norm-L4"])
@pytest.mark.parametrize("variant", ["downscale_lst_sr_to_lr", "downscale_lst_sr_to_lr_test"])
def test_downscale_ops_match_jax(rng, variant, deci_type):
    """1e-5 relative to the data's scale: float32 matmuls summed in another
    order. The norm-L4 form runs on Kelvin-scale values as in the pipeline
    (the 4th root of a mean of 4th powers needs positive data)."""
    x = rng.normal(size=(2, 1, 64, 64)).astype(np.float32)
    if deci_type == "norm-L4":
        x = x * STD + MEAN
    got = getattr(psf, variant)(_t(x), deci_type=deci_type)
    want = getattr(jax_psf, variant)(jnp.asarray(x), deci_type=deci_type)
    _close(got, want, 1e-5 * max(1.0, float(np.abs(x).max())))


def test_lowpass_and_resize_match_jax(rng):
    x = rng.normal(size=(2, 1, 64, 64)).astype(np.float32)
    _close(psf.lowpass_ftm(_t(x), mtf=0.25), jax_psf.lowpass_ftm(jnp.asarray(x), mtf=0.25))
    _close(resize.downsample_bicubic(_t(x)), jax_resize.downsample_bicubic(jnp.asarray(x)))
    _close(resize.cubic_resize(_t(x), (48, 80)), jax_resize.cubic_resize(jnp.asarray(x), (48, 80)))
    _close(resize.upsample_bicubic(_t(x[..., :16, :16])),
           jax_resize.upsample_bicubic(jnp.asarray(x[..., :16, :16])))


def test_pooling_and_filters_match_jax(rng):
    x = (rng.normal(size=(2, 64, 64)) * STD + MEAN).astype(np.float32)
    _close(pooling.norm_l4_downsample(_t(x)), jax_pooling.norm_l4_downsample(jnp.asarray(x)),
           1e-5 * 330.0)
    _close(pooling.avg_pool_2x2(_t(x)), jax_pooling.avg_pool_2x2(jnp.asarray(x)), 1e-5 * 330.0)
    y = rng.normal(size=(2, 32, 40, 1)).astype(np.float32)
    _close(filters.directional_gradients(_t(y)), jax_filters.directional_gradients(jnp.asarray(y)))
    np.testing.assert_array_equal(filters.sobel_bank(), jax_filters.sobel_bank())


def test_psnr_ssim_match_jax(rng):
    t = rng.normal(size=(3, 64, 64)).astype(np.float32)
    p = (t + 0.3 * rng.normal(size=t.shape)).astype(np.float32)
    _close(metrics.psnr_batch_mean(_t(p), _t(t)),
           jax_metrics.psnr_batch_mean(jnp.asarray(p), jnp.asarray(t)))
    _close(metrics.ssim_batch_mean(_t(p), _t(t)),
           jax_metrics.ssim_batch_mean(jnp.asarray(p), jnp.asarray(t)))
    dr = np.float32(t.max() - t.min())
    _close(metrics.ssim(_t(p), _t(t), torch.tensor(dr)),
           jax_metrics.ssim(jnp.asarray(p), jnp.asarray(t), jnp.asarray(dr)))
    _close(metrics.psnr(_t(p[0]), _t(t[0]), torch.tensor(dr)),
           jax_metrics.psnr(jnp.asarray(p[0]), jnp.asarray(t[0]), jnp.asarray(dr)))


def _loss_inputs(rng):
    sr = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
    lst = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    ndvi = rng.normal(size=(2, 64, 64, 1)).astype(np.float32)
    return sr, lst, ndvi


@pytest.mark.parametrize("name", ["huber", "ds_loss", "percep_loss_predef", "percep_loss_gradftm",
                                  "sif_loss_predef", "sif_loss_gradftm", "scale_invariance_loss"])
def test_loss_matches_jax(rng, name):
    """Each of the seven loss functions on the same inputs, 2e-5 (the bound
    the JAX package's own loss tests hold against the torch goldens)."""
    sr, lst, ndvi = _loss_inputs(rng)
    args = {
        "huber": (3.0 * sr, ndvi),
        "ds_loss": (sr, lst, MEAN, STD),
        "percep_loss_predef": (sr, ndvi, -0.5),
        "percep_loss_gradftm": (sr, ndvi, -0.5),
        "sif_loss_predef": (sr, lst, ndvi, 0.99, -0.5, MEAN, STD),
        "sif_loss_gradftm": (sr, lst, ndvi, 0.99, -0.5, MEAN, STD),
        "scale_invariance_loss": (sr, ndvi),
    }[name]
    got = getattr(losses, name)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args])
    want = getattr(jax_losses, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                      for a in args])
    if isinstance(got, tuple):
        assert got[1].keys() == want[1].keys()
        for k in got[1]:
            assert abs(float(got[1][k]) - float(want[1][k])) < 2e-5, k
        got, want = got[0], want[0]
    assert got.dim() == 0
    assert abs(float(got) - float(want)) < 2e-5


def test_ds_loss_routes_agree(rng):
    """use_pallas=None on a CPU tensor is the matmul chain; True goes through
    the kernel's wrapper (its plain version here); both give one value."""
    sr, lst, _ = _loss_inputs(rng)
    chain = losses.ds_loss(_t(sr), _t(lst), MEAN, STD)
    assert float(chain) == float(losses.ds_loss(_t(sr), _t(lst), MEAN, STD, use_pallas=False))
    via_wrapper = losses.ds_loss(_t(sr), _t(lst), MEAN, STD, use_pallas=True)
    assert abs(float(chain) - float(via_wrapper)) < 1e-6


def _nhwc(x):
    return _t(np.transpose(x, (0, 2, 3, 1)))


def test_predef_losses_match_golden():
    fx = np.load(require_golden("losses_predef.npz"))
    sr, lst, ndvi = _nhwc(fx["sr"]), _nhwc(fx["lst"]), _nhwc(fx["ndvi"])
    mean, std = float(fx["mean_lst"]), float(fx["std_lst"])
    assert abs(float(losses.ds_loss(sr, lst, mean, std)) - float(fx["ds_loss"])) < 2e-5
    assert abs(float(losses.ds_loss(sr, lst, mean, std, use_pallas=True))
               - float(fx["ds_loss"])) < 2e-5
    assert abs(float(losses.percep_loss_predef(sr, ndvi, float(fx["gamma"])))
               - float(fx["percep_loss"])) < 2e-5
    total, _ = losses.sif_loss_predef(sr, lst, ndvi, float(fx["alpha"]), float(fx["gamma"]),
                                      mean, std)
    assert abs(float(total) - float(fx["total"])) < 2e-5


def test_gradftm_losses_match_golden():
    fx = np.load(require_golden("losses_gradftm.npz"))
    sr, ndvi = _nhwc(fx["sr"]), _nhwc(fx["ndvi"])
    got = losses.percep_loss_gradftm(sr, ndvi, float(fx["gamma"]))
    assert abs(float(got) - float(fx["percep_loss"])) < 2e-5


def test_synthetic_dataset_and_batches_equal_jax():
    """Pure numpy from the seed: identical arrays and batch order."""
    ours, theirs = datasets.make_synthetic_dataset(5, seed=3), jax_datasets.make_synthetic_dataset(5, seed=3)
    np.testing.assert_array_equal(ours.lst, theirs.lst)
    np.testing.assert_array_equal(ours.ndvi, theirs.ndvi)
    assert ours.n_batches(2, drop_remainder=False) == theirs.n_batches(2, drop_remainder=False) == 3
    for a, b in zip(ours.batches(2, seed=11, drop_remainder=False),
                    theirs.batches(2, seed=11, drop_remainder=False)):
        np.testing.assert_array_equal(a["lst"], b["lst"])
        np.testing.assert_array_equal(a["ndvi"], b["ndvi"])
    assert [b["lst"].shape[0] for b in ours.batches(2, drop_remainder=False)] == [2, 2, 1]


def test_prepare_and_degrade_batch_match_jax():
    ds = datasets.make_synthetic_dataset(3, seed=4)
    batch = next(ds.batches(3, seed=0))
    got = datasets.prepare_batch(batch, device="cpu")
    want = jax_datasets.prepare_batch(batch)
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])
    got = datasets.degrade_batch_scale_invariance(batch, MEAN, STD, device="cpu")
    want = jax_datasets.degrade_batch_scale_invariance(batch, MEAN, STD)
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k], 2e-5)   # (x - 295)/10 after a Kelvin-scale resize
    assert got["lst_up"].shape == (3, 64, 64, 1) and got["ndvi"].shape == (3, 64, 64, 1)


@pytest.mark.parametrize("transf", ["norm", "0-1", "-1_1"])
def test_normalize_roundtrip_equals_jax(rng, transf):
    stats = Statistics(maxi=330.0, mini=260.0, mean_lst=MEAN, std_lst=STD, mean_ndvi=0.3,
                       std_ndvi=0.25)
    lst = (290.0 + 20.0 * rng.random((2, 8, 8))).astype(np.float32)
    ndvi = rng.random((2, 32, 32)).astype(np.float32)
    got, want = datasets.normalize(lst, ndvi, stats, transf), jax_datasets.normalize(lst, ndvi, stats, transf)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(datasets.denormalize(got[0], stats, transf),
                                  jax_datasets.denormalize(want[0], stats, transf))
    with pytest.raises(ValueError, match="transf"):
        datasets.normalize(lst, ndvi, stats, "log")


@pytest.mark.parametrize("writer,reader", [(jax_tiff, tiff), (tiff, jax_tiff)])
def test_geotiff_copy_reads_what_the_other_package_writes(tmp_path, rng, writer, reader):
    """The port keeps its own copy of the numpy-only GeoTIFF module: either
    package reads what the other writes."""
    arr = (290.0 + 20.0 * rng.random((64, 48))).astype(np.float32)
    path = str(tmp_path / "patch.tif")
    writer.write_geotiff(path, arr)
    got = reader.read_geotiff(path)
    np.testing.assert_array_equal(got.array, arr)
    assert got.array.dtype == np.float32


def _write_manifest(tmp_path, rng, write_geotiff, n=3):
    import csv

    rows = []
    (tmp_path / "pairs").mkdir()
    for i in range(n):
        ndvi = (0.3 + 0.2 * rng.random((256, 256))).astype(np.float32)
        lst = (300.0 - 20.0 * ndvi[::4, ::4] + 0.05 * rng.normal(size=(64, 64))).astype(np.float32)
        tag = "day" if i != 1 else "night"
        lst_p = tmp_path / "pairs" / f"MOD21A1D_{tag}.A2020{100 + i:03d}.{i}.tif"
        ndvi_p = tmp_path / "pairs" / f"MOD09GQ.A2020{100 + i:03d}.{i}.tif"
        write_geotiff(str(lst_p), lst)
        write_geotiff(str(ndvi_p), ndvi)
        rows.append({"LST": str(lst_p), "NDVI": str(ndvi_p), "split": "Train" if i < 2 else "Val"})
    path = tmp_path / "ModisDatasetB.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["LST", "NDVI", "split"])
        w.writeheader()
        w.writerows(rows)
    return str(path)


def test_modis_dataset_equals_jax(tmp_path, rng):
    """A manifest written with the JAX package's writer decodes to the same
    normalised arrays through either package; split and time filters agree."""
    stats = Statistics(maxi=330.0, mini=260.0, mean_lst=MEAN, std_lst=STD, mean_ndvi=0.3,
                       std_ndvi=0.25)
    csv_path = _write_manifest(tmp_path, rng, jax_tiff.write_geotiff)
    ours = datasets.ModisDataset(csv_path, stats, split="Train")
    theirs = jax_datasets.ModisDataset(csv_path, stats, split="Train")
    assert len(ours) == len(theirs) == 2 and ours.paths == theirs.paths
    np.testing.assert_array_equal(ours.lst, theirs.lst)
    np.testing.assert_array_equal(ours.ndvi, theirs.ndvi)
    assert len(datasets.ModisDataset(csv_path, stats, split="Train", time="day")) == 1
    assert len(datasets.ModisDataset(csv_path, stats, split="Val")) == 1
    empty = datasets.ModisDataset(csv_path, stats, split="Test")
    assert len(empty) == 0 and empty.ndvi.shape == (0, 256, 256)


def test_config_copy_equals_jax():
    from sifsr_tpu import config as jax_config
    import dataclasses

    ours = port_config.load_params_json(os.path.join(ROOT, "paramsB.json"), recipe="gradftm")
    theirs = jax_config.load_params_json(os.path.join(ROOT, "paramsB.json"), recipe="gradftm")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.hyper.batch_size == 32 and ours.hyper.alpha == 0.99 and ours.hyper.gamma == -0.5
    assert tuple(ours.model.downchannels) == (16, 32, 64, 128)
