"""The port's granule modes against the JAX package's predict_granule (CPU):
device tiling, the integer wire format, the ``mode`` selector with its link
probe, and the ``pad_impl='fused'`` float step.

The granule is small (48x80 LST at window 16: 15 blocks, a last batch of 3
at batch 4, which the JAX package pads and the port's host pipeline steps
at its own rows, one 0 K block masked by coverage) so that the JAX side,
which compiles at the suite's XLA opt level 0, stays quick. Tolerances: the
float32 steps agree to rtol 1e-5 / atol 2e-4 K (summation order of the
convs and resize matmuls, as tests/test_torch_int8_serving.py holds the
host pipeline); the wire output is a multiple of 0.02 K, so a float32
difference below that can move one code: one step, 0.02 K, is allowed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu import inference as jax_inference
from sifsr_tpu.cli.predict import load_variables as jax_load_variables
from sifsr_tpu.data.statistics import Statistics as JaxStatistics
from sifsr_tpu.models.unet import ModelB2 as JaxModelB2

from sifsr_tpu_torch import inference
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics

import os

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")
KW = dict(batch_size=4, window=16, coverage=0.05)
WIRE_STEP = 0.02


@pytest.fixture(scope="module")
def weights():
    return load_variables(WEIGHTS), jax_load_variables(WEIGHTS, "modelB", JaxModelB2())


@pytest.fixture(scope="module")
def stats():
    return Statistics.from_json(STATS_JSON), JaxStatistics.from_json(STATS_JSON)


@pytest.fixture(scope="module")
def granule():
    rng = np.random.default_rng(7)
    lst = (296.0 + 20.0 * rng.random((48, 80))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((192, 320))).astype(np.float32)
    lst[16:32, 32:48] = 0.0
    return lst, ndvi


def _port(weights, stats, granule, **kw):
    return inference.predict_granule(weights[0], *granule, stats[0], compute_dtype=torch.float32,
                                     device="cpu", **KW, **kw)


def _jax(weights, stats, granule, **kw):
    return np.asarray(jax_inference.predict_granule(
        weights[1], *granule, stats[1], compute_dtype=jnp.float32, **KW, **kw))


@pytest.fixture(scope="module")
def host_pipeline(weights, stats, granule):
    return _port(weights, stats, granule, pad_impl="explicit")


def test_device_tiling_matches_jax_and_host_pipeline(weights, stats, granule, host_pipeline):
    want = _jax(weights, stats, granule, pad_impl="explicit", device_tiling=True)
    got = _port(weights, stats, granule, pad_impl="explicit", device_tiling=True)
    assert got.shape == want.shape == (192, 320) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    assert np.all(got[64:128, 128:192] == 0.0) and np.all(got[:64] > 250.0)
    # same batches through the same step: the two modes agree exactly
    np.testing.assert_array_equal(got, host_pipeline)


@pytest.mark.parametrize("device_tiling", [False, True])
def test_wire_int_matches_jax(weights, stats, granule, host_pipeline, device_tiling):
    want = _jax(weights, stats, granule, pad_impl="explicit", wire="int",
                device_tiling=device_tiling)
    got = _port(weights, stats, granule, pad_impl="explicit", wire="int",
                device_tiling=device_tiling)
    assert got.dtype == np.float32 and got.shape == want.shape
    codes = got / np.float32(WIRE_STEP)
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-2)      # multiples of 0.02 K
    assert np.abs(got - want).max() <= WIRE_STEP + 1e-4
    assert (got != want).mean() < 0.01
    # against the float wire: half a step of output rounding, plus the
    # model's response to NDVI rounded to 1e-4 and LST to 0.02 K
    assert np.abs(got - host_pipeline).max() < 0.05
    assert np.all(got[64:128, 128:192] == 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_int_on_a_granule_of_wire_steps(weights, stats, granule, dtype):
    """On a granule that holds multiples of the wire's steps (LST 0.02 K,
    NDVI 1e-4, as MODIS products do) the step sees the same inputs on either
    wire, so whatever the step's dtype only the mosaic's rounding to 0.02 K
    is left: half a step and a float32 ulp (3e-5 K at 300 K)."""
    lst_w, ndvi_w = inference.encode_wire(*granule)
    exact = (lst_w.astype(np.float32) * np.float32(inference.WIRE_LST_STEP),
             ndvi_w.astype(np.float32) * np.float32(inference.WIRE_NDVI_STEP))
    for g, w in zip(inference.encode_wire(*exact), (lst_w, ndvi_w)):
        np.testing.assert_array_equal(g, w)
    kw = dict(compute_dtype=dtype, device="cpu", **KW)
    want = inference.predict_granule(weights[0], *exact, stats[0], **kw)
    for device_tiling in (False, True):
        got = inference.predict_granule(weights[0], *exact, stats[0], wire="int",
                                        device_tiling=device_tiling, **kw)
        assert np.abs(got - want).max() <= 0.0101
        assert np.all(got[64:128, 128:192] == 0.0)


def test_encode_wire_equals_jax(granule):
    lst, ndvi = granule
    got, want = inference.encode_wire(lst, ndvi), jax_inference.encode_wire(lst, ndvi)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert inference.WIRE_LST_STEP == jax_inference.WIRE_LST_STEP
    assert inference.WIRE_NDVI_STEP == jax_inference.WIRE_NDVI_STEP


def test_mode_selector(weights, stats, granule, host_pipeline, capsys):
    """mode overrides device_tiling/wire as in the JAX package; 'auto'
    measures the link and the step once and logs its decision."""
    np.testing.assert_array_equal(
        _port(weights, stats, granule, pad_impl="explicit", mode="host_pipeline",
              device_tiling=True), host_pipeline)
    np.testing.assert_array_equal(
        _port(weights, stats, granule, pad_impl="explicit", mode="device_tiling"), host_pipeline)
    np.testing.assert_array_equal(
        _port(weights, stats, granule, pad_impl="explicit", mode="device_tiling_wire"),
        _port(weights, stats, granule, pad_impl="explicit", device_tiling=True, wire="int"))
    capsys.readouterr()
    auto = _port(weights, stats, granule, pad_impl="explicit", mode="auto")
    err = capsys.readouterr().err
    assert "predict_granule auto mode" in err and "patches_per_s" in err
    np.testing.assert_array_equal(auto, host_pipeline)
    with pytest.raises(ValueError, match="mode must be"):
        _port(weights, stats, granule, mode="bogus")
    with pytest.raises(ValueError, match="wire must be"):
        _port(weights, stats, granule, wire="f16")
    with pytest.raises(ValueError, match="overlap"):
        _port(weights, stats, granule, device_tiling=True, overlap=4)


def test_probe_link_and_mode_model():
    """probe_link measures and caches; choose_granule_mode is the JAX
    package's model with its two constants passed in as measurements."""
    link = inference.probe_link("cpu", bulk_mb=4)
    assert link is inference.probe_link("cpu")
    assert all(link[k] > 0 for k in ("rtt_s", "h2d_bytes_per_s", "d2h_bytes_per_s",
                                     "host_bytes_per_s"))
    for probe in ({"rtt_s": 1e-4, "h2d_bytes_per_s": 2e10, "d2h_bytes_per_s": 2e10},
                  {"rtt_s": 5e-2, "h2d_bytes_per_s": 3e7, "d2h_bytes_per_s": 3e7},
                  {"rtt_s": 2e-2, "h2d_bytes_per_s": 5e9, "d2h_bytes_per_s": 5e9}):
        want = jax_inference.choose_granule_mode((1200, 1200), 64, 4, 64, link=probe)
        got = inference.choose_granule_mode(
            (1200, 1200), 64, 4, 64, patches_per_s=jax_inference._EST_PATCHES_PER_S,
            link=dict(probe, host_bytes_per_s=jax_inference._EST_HOST_BYTES_PER_S))
        assert got["mode"] == want["mode"]
        assert got["t_device_tiling_s"] == want["t_device_tiling_s"]
        assert got["t_host_pipeline_s"] == want["t_host_pipeline_s"]
    assert {got["mode"] for got in (
        inference.choose_granule_mode((1200, 1200), 64, 4, 64, 8000.0, link=dict(
            p, host_bytes_per_s=4e9)) for p in (
                {"rtt_s": 5e-2, "h2d_bytes_per_s": 2e10, "d2h_bytes_per_s": 2e10},
                {"rtt_s": 1e-4, "h2d_bytes_per_s": 3e7, "d2h_bytes_per_s": 3e7}))} == {
        "device_tiling", "host_pipeline"}


def test_pad_impl_fused_matches_jax_fused(weights, stats, granule, host_pipeline):
    """The pad_impl='fused' float32 step vs JAX's fused step, and against the
    explicit pads: the two differ by summation order at block borders only
    (about an ulp of the normalised output, a few 1e-5 K). Left to itself the
    step pads by dtype: explicit in float32, fused in bf16 (identical rasters
    to the pad named outright)."""
    want = _jax(weights, stats, granule)                 # JAX default: fused
    got = _port(weights, stats, granule, pad_impl="fused")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    d = np.abs(got - host_pipeline)
    assert 0.0 < d.max() < 1e-3
    np.testing.assert_array_equal(_port(weights, stats, granule), host_pipeline)
    bf16 = {pad: inference.predict_granule(weights[0], *granule, stats[0], device="cpu",
                                           pad_impl=pad, **KW)
            for pad in (None, "fused", "explicit")}
    np.testing.assert_array_equal(bf16[None], bf16["fused"])
    assert np.any(bf16[None] != bf16["explicit"])
    with pytest.raises(ValueError, match="pad_impl"):
        inference.make_sr_step(stats[0], torch.float32, "cpu", "bogus")
