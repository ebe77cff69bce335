"""The port's ASTER evaluation CLI (``sifsr_tpu_torch.cli.model_perf``)
against the JAX package's on synthetic pairs in the harness's format
(``chip_smoke.write_aster_pairs``), ModelB_2 at full width from
weights/modelB_1009. JAX's int8 kernels (interpret mode) stay off these
tests: the port's int8 steps are held against them in their own tests."""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from sifsr_tpu.cli import model_perf as jmp
from sifsr_tpu.data.statistics import Statistics as JaxStatistics
from sifsr_tpu.models.pallas_serving import build_pallas_serving_params

from sifsr_tpu_torch.cli import model_perf as tmp_
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.eval.harness import METRIC_COLUMNS
from sifsr_tpu_torch.models.int8_serving import build_int8_serving_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")
N_PAIRS = 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sys.path.insert(0, ROOT)
    from chip_smoke import write_aster_pairs

    d = str(tmp_path_factory.mktemp("aster_pairs"))
    write_aster_pairs(d, N_PAIRS, seed=13)
    return d


def test_calibration_pairs_equal_jax(dataset):
    got = tmp_._load_calibration_pairs(dataset, 3)
    want = jmp._load_calibration_pairs(dataset, 3)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape[0] == 3
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scale_invariance", [False, True])
def test_f32_sr_fn_matches_jax(dataset, scale_invariance):
    """The f32 sr_fn (ModelB2 in eval mode, float32; with
    --scale-invariance on the pair's 16 64² tiles) on two pairs within
    1e-4 K of JAX's."""
    port = tmp_.make_sr_fn("modelB", WEIGHTS, STATS_JSON, scale_invariance, device="cpu")
    ref = jmp.make_sr_fn("modelB", WEIGHTS, STATS_JSON, scale_invariance)
    lst, ndvi = tmp_._load_calibration_pairs(dataset, 2)
    for i in range(2):
        got, want = port(lst[i], ndvi[i]), np.asarray(ref(lst[i], ndvi[i]))
        assert got.shape == want.shape == (256, 256) and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4


def test_bf16_sr_fn_matches_jax(dataset):
    """The bf16 sr_fn (fused pads on both sides) against JAX's within the
    bound of the bf16 step's own test against JAX
    (tests/test_torch_model.py::test_bf16_step_matches_jax): RMSE within
    half a bf16 ulp of the largest normalised output, max within two, plus
    the float32 spacing of a 256-512 K output (2^-15 K) here, where the step
    returns Kelvin; and both within the bf16 step's bound of the float32
    function (RMSE 0.1 K, max 0.5 K)."""
    stats = Statistics.from_json(STATS_JSON)
    port = tmp_.make_sr_fn("modelB", WEIGHTS, STATS_JSON, serving="bf16", device="cpu")
    ref = jmp.make_sr_fn("modelB", WEIGHTS, STATS_JSON, serving="bf16")
    f32 = tmp_.make_sr_fn("modelB", WEIGHTS, STATS_JSON, device="cpu")
    lst, ndvi = tmp_._load_calibration_pairs(dataset, 1)
    got, want, exact = port(lst[0], ndvi[0]), np.asarray(ref(lst[0], ndvi[0])), f32(lst[0], ndvi[0])
    top = np.abs((exact - stats.mean_lst) / stats.std_lst).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) * stats.std_lst
    d = got - want
    assert np.sqrt((d ** 2).mean()) <= ulp / 2 and np.abs(d).max() <= 2 * ulp + 2.0 ** -15
    for out in (got, want):
        assert np.sqrt(((out - exact) ** 2).mean()) < 0.1 and np.abs(out - exact).max() < 0.5


def test_prow_quantile_scales_equal_jax(dataset):
    """--calib-quantile 0.9999 (model_perf's default): the port's int8
    scales (the per-tensor record ``s`` and every mid-chain conv's
    ``in_scale``) against JAX's build_pallas_serving_params on the same
    calibration pairs. Both take jnp.quantile's float32 rule
    (ops.quantile); the activations they rank differ only by the float32
    summation order of the two convolutions, so each scale agrees to 2e-6
    relative (a few float32 ulps)."""
    lst, ndvi = tmp_._load_calibration_pairs(dataset, N_PAIRS)
    got = build_int8_serving_params(load_variables(WEIGHTS), lst, ndvi,
                                    Statistics.from_json(STATS_JSON), calib_quantile=0.9999,
                                    device="cpu")
    from sifsr_tpu.cli.predict import load_variables as jax_load_variables
    from sifsr_tpu.models.unet import ModelB2 as JaxModelB2

    want = build_pallas_serving_params(
        jax_load_variables(WEIGHTS, "modelB", JaxModelB2()), lst, ndvi,
        JaxStatistics.from_json(STATS_JSON), calib_quantile=0.9999)
    assert set(got["s"]) == set(want["s"])
    for k in want["s"]:
        np.testing.assert_allclose(float(got["s"][k]), float(want["s"][k]), rtol=2e-6, err_msg=k)

    def in_scales(tree, path=()):
        if "in_scale" in tree:
            yield path, float(tree["in_scale"])
            return
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from in_scales(v, path + (k,))

    got_mid, want_mid = dict(in_scales(got["mid"])), dict(in_scales(want["mid"]))
    assert set(got_mid) == set(want_mid) and len(got_mid) == 13   # db1-db3: 3 convs, ub1-ub2: 2
    for k in want_mid:
        np.testing.assert_allclose(got_mid[k], want_mid[k], rtol=2e-6, err_msg=str(k))


def test_main_fills_lpips_from_weight_files(dataset, tmp_path):
    """``main`` with --vgg16-weights/--lpips-weights (seeded full-width VGG16
    in torchvision's layout, non-negative layer weights) writes a
    performances.csv in the reference's layout whose LPIPS column is filled
    (tests/test_vgg_lpips.py:150 with synthetic pairs); --device-metrics
    gives the host path's columns within 2e-4."""
    from chip_smoke import write_lpips_weights

    vgg, lp = write_lpips_weights(str(tmp_path))
    frames = {}
    for extra in ([], ["--device-metrics"]):
        out = tmp_path / ("dev" if extra else "host")
        tmp_.main(["--sr-type", "bicubic", "--dataset", dataset, "--statistics", STATS_JSON,
                   "--limit", "2", "--vgg16-weights", vgg, "--lpips-weights", lp,
                   "--out", str(out), "--device", "cpu", *extra])
        frames[bool(extra)] = pd.read_csv(out / "performances.csv", index_col=0)
    df = frames[False]
    assert list(df.columns) == list(METRIC_COLUMNS)
    pair_rows = df.drop(index=["mean", "std", "10%", "Q1", "mediane", "Q3", "90%"])
    assert len(pair_rows) == 2
    assert np.isfinite(pair_rows["LPIPS"]).all() and (pair_rows["LPIPS"] > 0).all()
    assert np.isfinite(df.loc["mean", "LPIPS"])
    np.testing.assert_allclose(frames[True].to_numpy(float), df.to_numpy(float),
                               rtol=2e-4, atol=2e-4)


def test_baseline_sr_types_raise_not_implemented(dataset):
    """The classical baselines, which raised NotImplementedError until they
    were ported, now build and sharpen a pair of the harness (each against
    JAX's in tests/test_torch_baselines.py); bicubic as before."""
    lst, ndvi = tmp_._load_calibration_pairs(dataset, 1)
    for sr_type in ("TsHARP", "ATPRK", "AATPRK", "DMS"):
        out = tmp_.make_sr_fn(sr_type, WEIGHTS, STATS_JSON, device="cpu")(lst[0], ndvi[0])
        assert out.shape == (256, 256) and np.isfinite(out).all()
    fn = tmp_.make_sr_fn("bicubic", "", "", device="cpu")
    lst = np.full((64, 64), 300.0, np.float32)
    np.testing.assert_allclose(fn(lst, None), np.full((256, 256), 300.0), rtol=1e-6)
    assert torch.get_default_dtype() == torch.float32
