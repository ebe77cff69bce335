"""The port's float path against the JAX package and the torch goldens:
weights decoding, resize matrices, ModelB2, BN folding and the float step."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sifsr_tpu.cli.predict import load_variables as jax_load_variables
from sifsr_tpu.data.statistics import Statistics as JaxStatistics
from sifsr_tpu.inference import make_sr_step as jax_make_sr_step
from sifsr_tpu.models.fused import fold_batchnorm as jax_fold_batchnorm
from sifsr_tpu.models.unet import ModelB2 as JaxModelB2
from sifsr_tpu.ops import resize as jax_resize

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.inference import make_sr_step
from sifsr_tpu_torch.models.convert import load_msgpack_variables
from sifsr_tpu_torch.models.fused import InferenceModelB2, fold_batchnorm
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.ops import resize

from conftest import require_golden

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
CHECKPOINTS = ["modelB_1009", "modelB_2609", "modelB_2011"]
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")


def _weights(name):
    return os.path.join(ROOT, "weights", name)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def test_msgpack_decoder_matches_flax():
    """The port's own msgpack decoder yields the arrays flax deserialises."""
    ours = dict(_leaves(load_msgpack_variables(
        os.path.join(_weights("modelB_1009"), "modelB_variables.msgpack"))))
    flax = dict(_leaves(jax.device_get(jax_load_variables(
        _weights("modelB_1009"), "modelB", JaxModelB2()))))
    assert ours.keys() == flax.keys()
    for k in ours:
        assert ours[k].dtype == flax[k].dtype and ours[k].shape == flax[k].shape, k
        np.testing.assert_array_equal(ours[k], flax[k])


def test_param_count_matches_reference():
    """282,705 learnable parameters, as the reference's modelB_1009."""
    model = ModelB2()
    model.load_state_dict(load_variables(_weights("modelB_1009")), strict=True)
    assert sum(p.numel() for p in model.parameters()) == 282_705


@pytest.mark.parametrize("name", CHECKPOINTS)
@pytest.mark.parametrize("which", ["rand", "real"])
def test_forward_matches_golden(name, which):
    """ModelB2 vs the reference torch outputs in golden/ (the JAX package's
    tolerance, tests/test_model_parity.py:33)."""
    fx = np.load(require_golden(f"modelB_forward_{name}.npz"))
    model = ModelB2()
    model.load_state_dict(load_variables(_weights(name)), strict=True)
    model.eval()
    x = torch.from_numpy(fx[f"{which}_input"].transpose(0, 2, 3, 1).copy())
    with torch.no_grad():
        got = model(x).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, fx[f"{which}_output"], rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("in_size,out_size,kind",
                         [(64, 256, "cubic"), (256, 64, "cubic"), (32, 64, "linear_ac")])
def test_resize_matrix_matches_jax(in_size, out_size, kind):
    np.testing.assert_array_equal(resize.resize_matrix(in_size, out_size, kind),
                                  jax_resize.resize_matrix(in_size, out_size, kind))


@pytest.mark.parametrize("fn", ["upsample_bicubic", "upsample_bilinear_x2"])
def test_upsample_matches_jax(rng, fn):
    x = (300.0 + 10.0 * rng.random((3, 32, 32))).astype(np.float32)
    want = np.asarray(getattr(jax_resize, fn)(jnp.asarray(x)))
    got = getattr(resize, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_fold_batchnorm_matches_jax():
    sd = load_variables(_weights("modelB_1009"))
    jv = jax_load_variables(_weights("modelB_1009"), "modelB", JaxModelB2())
    want = dict(_leaves(jax.device_get(jax_fold_batchnorm(jv))["params"]))
    got = dict(_leaves({k: v for k, v in fold_batchnorm(sd).items()}))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=str(k))


def _blocks(rng, n, size):
    lst = (296.0 + 20.0 * rng.random((n, size, size))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((n, 4 * size, 4 * size))).astype(np.float32)
    return lst, ndvi


def test_f32_step_matches_jax(rng):
    """The float32 step vs JAX's (f32, pad_impl pinned to 'explicit', the
    port's only pad form): same function, float32 summation-order noise."""
    sd = load_variables(_weights("modelB_1009"))
    jv = jax_load_variables(_weights("modelB_1009"), "modelB", JaxModelB2())
    lst, ndvi = _blocks(rng, 2, 32)
    want = np.asarray(jax_make_sr_step(JaxModelB2(), JaxStatistics.from_json(STATS_JSON),
                                       jnp.float32, pad_impl="explicit")(
        jv, jnp.asarray(lst), jnp.asarray(ndvi)))
    stats = Statistics.from_json(STATS_JSON)
    got = make_sr_step(stats, torch.float32, "cpu")(InferenceModelB2.from_variables(sd),
                                                    lst, ndvi).numpy()
    assert got.shape == (2, 128, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


def test_bf16_step_close_to_f32(rng):
    """The bf16 step stays within bf16 rounding of the float32 step (the JAX
    package documents ~0.01 K for its bf16 serving path)."""
    sd = load_variables(_weights("modelB_1009"))
    stats = Statistics.from_json(STATS_JSON)
    lst, ndvi = _blocks(rng, 2, 16)
    model = InferenceModelB2.from_variables(sd)
    a = make_sr_step(stats, torch.float32, "cpu")(model, lst, ndvi).numpy()
    b = make_sr_step(stats, torch.bfloat16, "cpu")(model.to(torch.bfloat16), lst, ndvi).numpy()
    d = a - b
    assert np.sqrt((d ** 2).mean()) < 0.1 and np.abs(d).max() < 0.5


def test_bf16_step_matches_jax(rng):
    """The bf16 step, ``predict_granule``'s default, vs JAX's bf16 step
    (pad_impl pinned to 'explicit').

    Both run the U-Net in bf16 (8-bit mantissa) but do not round at the same
    points: PyTorch rounds every op's output to bf16, XLA may keep a fused
    chain in f32 and round once. The outputs therefore differ by a few ulps
    of the bf16 output, not by summation-order noise. With ``ulp`` the bf16
    spacing at the largest normalised output (2^(e-7) for a largest value in
    [2^e, 2^(e+1)), times std_lst): RMSE <= ulp / 2 and max|d| <= 2 ulps.
    The port's step must also stay at least as close to the float32 function
    as JAX's bf16 step is."""
    sd = load_variables(_weights("modelB_1009"))
    jv = jax_load_variables(_weights("modelB_1009"), "modelB", JaxModelB2())
    stats = Statistics.from_json(STATS_JSON)
    lst, ndvi = _blocks(rng, 2, 32)
    want = np.asarray(jax_make_sr_step(JaxModelB2(), JaxStatistics.from_json(STATS_JSON),
                                       jnp.bfloat16, pad_impl="explicit")(
        jv, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = make_sr_step(stats, torch.bfloat16, "cpu")(
        InferenceModelB2.from_variables(sd).to(torch.bfloat16), lst, ndvi).numpy()
    f32 = make_sr_step(stats, torch.float32, "cpu")(
        InferenceModelB2.from_variables(sd), lst, ndvi).numpy()
    assert got.shape == want.shape == (2, 128, 128)

    def rmse(d):
        return float(np.sqrt((d ** 2).mean()))

    top = np.abs((f32 - stats.mean_lst) / stats.std_lst).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) * stats.std_lst
    d = got - want
    assert rmse(d) <= ulp / 2 and np.abs(d).max() <= 2 * ulp, (ulp, rmse(d), np.abs(d).max())
    assert rmse(got - f32) <= rmse(want - f32)
