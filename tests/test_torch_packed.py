"""The port's space-to-depth packed serving steps (float and int8) and
``upsample_bilinear_x2_nhwc_hp`` against the JAX package on the CPU, on the
same parameters carried across, seeded 32² LST / 128² NDVI blocks and
weights/modelB_1009."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sifsr_tpu.cli.predict import load_variables as jax_load_variables
from sifsr_tpu.data.statistics import Statistics as JaxStatistics
from sifsr_tpu.models import packed as jax_packed
from sifsr_tpu.models import quantized_packed as jax_qpacked
from sifsr_tpu.models.unet import ModelB2 as JaxModelB2
from sifsr_tpu.ops.resize import upsample_bilinear_x2_nhwc_hp as jax_upsample_hp

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.inference import make_sr_step
from sifsr_tpu_torch.models import packed, quantized, quantized_packed
from sifsr_tpu_torch.models.fused import InferenceModelB2
from sifsr_tpu_torch.ops.resize import upsample_bilinear_x2_nhwc_hp

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")

# the int8 packed steps against JAX's: the int8 convs are exact, and what may
# differ is float32 summation order (the resize einsums, the 2x2 means, the
# calibration convs), which can flip a requantisation by one quantum (the
# mid='xla' test's bounds, tests/test_torch_int8_serving.py)
RMSE_K, MAX_K = 0.02, 0.5


@pytest.fixture(scope="module")
def weights():
    return (load_variables(WEIGHTS),
            jax_load_variables(WEIGHTS, "modelB", JaxModelB2()))


@pytest.fixture(scope="module")
def stats():
    return Statistics.from_json(STATS_JSON), JaxStatistics.from_json(STATS_JSON)


def _patches(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    lst = (296.0 + 20.0 * rng.random((n, size, size))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((n, 4 * size, 4 * size))).astype(np.float32)
    return lst, ndvi


def jax_tree_to_torch(tree):
    """A JAX parameter tree (``pack_serving_params``'s float tree, with its
    (kernel, bias) tuples, or ``quantize_packed_params``'s int8 tree,
    calibrated or not) -> the same tree of CPU tensors: the parameters
    carried across to the port."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(jax_tree_to_torch(v) for v in tree)
    a = np.array(tree)
    if a.dtype == jnp.bfloat16:            # numpy holds it as ml_dtypes' bfloat16
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def jax_int8_trees(weights, stats):
    """JAX's int8 packed tree, uncalibrated and calibrated on seeded patches,
    with the calibration patches."""
    tree = jax_qpacked.quantize_packed_params(weights[1])
    cal = _patches(1)
    return tree, jax_qpacked.calibrate_packed_scales(weights[1], tree, *cal, stats[1]), cal


def _diffs(got, want):
    d = got.astype(np.float64) - want
    return float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())


def _assert_trees_equal(got, want, path=()) -> int:
    """Same keys and tuple structure, every leaf of the same dtype and bits;
    returns the number of leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        return sum(_assert_trees_equal(got[k], want[k], path + (k,)) for k in want)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        return sum(_assert_trees_equal(a, b, path + (i,)) for i, (a, b) in enumerate(zip(got, want)))
    assert got.dtype == want.dtype and torch.equal(got, want), path
    return 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_step_matches_jax(weights, stats, dtype):
    """make_packed_sr_step vs JAX's on JAX's packed tree in that dtype,
    carried across: float32 within 1e-3 K (summation order), bf16 within the
    port's bf16 gate (RMSE 0.1 K, max 0.5 K)."""
    lst, ndvi = _patches(2)
    jtree = jax_packed.pack_serving_params(weights[1], getattr(jnp, dtype))
    want = np.asarray(jax_packed.make_packed_sr_step(stats[1], getattr(jnp, dtype))(
        jtree, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = packed.make_packed_sr_step(stats[0], getattr(torch, dtype), "cpu")(
        jax_tree_to_torch(jax.device_get(jtree)), lst, ndvi)
    assert got.shape == want.shape == (2, 128, 128) and got.dtype == torch.float32
    rmse, dmax = _diffs(got.numpy(), want)
    if dtype == "float32":
        assert dmax <= 1e-3, dmax
    else:
        assert rmse < 0.1 and dmax < 0.5, (rmse, dmax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_step_params_equal_jax_tree(weights, dtype):
    """packed_step_params is JAX's pack_serving_params(variables, dtype),
    leaf for leaf, bit-equal: the 18 folded convs under 'mid' and the five
    packed ones as (kernel, bias)."""
    want = jax_tree_to_torch(jax.device_get(
        jax_packed.pack_serving_params(weights[1], getattr(jnp, dtype))))
    got = packed.packed_step_params(weights[0], getattr(torch, dtype), "cpu")
    assert _assert_trees_equal(got, want) == 46


def test_packed_step_matches_standard_step(weights, stats):
    """The packed float32 step against the port's standard float32 step
    (explicit pads) on the same weights: the same function up to float
    associativity through 14 layers (JAX's packed-vs-standard bound)."""
    lst, ndvi = _patches(3)
    want = make_sr_step(stats[0], torch.float32, "cpu", "explicit")(
        InferenceModelB2.from_variables(weights[0]), lst, ndvi).numpy()
    got = packed.make_packed_sr_step(stats[0], torch.float32, "cpu")(
        packed.packed_step_params(weights[0], torch.float32, "cpu"), lst, ndvi).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)


def test_quantize_packed_params_equals_jax_tree(weights):
    """quantize_packed_params is JAX's tree leaf for leaf: q, scale and bias
    bit-equal, the packed leaves (3,3,4C,4K) / (4K,)."""
    got = quantized_packed.quantize_packed_params(weights[0], "cpu")
    want = jax_tree_to_torch(jax.device_get(jax_qpacked.quantize_packed_params(weights[1])))
    assert _assert_trees_equal(got, want) == 3 * 18
    assert got["packed"]["ub3_conv1"]["q"].dtype == torch.int8
    assert got["packed"]["ub3_conv1"]["q"].shape == (3, 3, 128, 64)
    assert got["packed"]["outlay"]["scale"].shape == (4,)


def test_calibrate_packed_scales_matches_jax(weights, stats, jax_int8_trees):
    """Every in_scale within rtol 1e-5 of JAX's (max|x| of float32 convs
    whose summation order differs), the rest of the tree untouched."""
    _, jcal, cal = jax_int8_trees
    tree = quantized_packed.quantize_packed_params(weights[0], "cpu")
    got = quantized_packed.calibrate_packed_scales(weights[0], tree, *cal, stats[0], device="cpu")
    n = 0

    def walk(t, j, src, path):
        nonlocal n
        if "q" in j:
            n += 1
            assert t.keys() == j.keys() and t["in_scale"].shape == ()
            assert t["in_scale"].dtype == torch.float32 and t["q"] is src["q"]
            np.testing.assert_allclose(float(t["in_scale"]), float(j["in_scale"]), rtol=1e-5,
                                       err_msg=str(path))
            return
        for k in j:
            walk(t[k], j[k], src[k], path + (k,))

    walk(got, jcal, tree, ())
    assert n == 18


@pytest.fixture(scope="module")
def jax_int8_steps(stats, jax_int8_trees):
    """JAX's int8 packed step on seeded blocks: calibrated -> (its tree, the
    blocks, the step's output)."""
    tree, jcal, _ = jax_int8_trees
    lst, ndvi = _patches(4)
    step = jax_qpacked.make_int8_packed_sr_step(stats[1])
    return {cal: (jtree, (lst, ndvi),
                  np.asarray(step(jtree, jnp.asarray(lst), jnp.asarray(ndvi))))
            for cal, jtree in ((True, jcal), (False, tree))}


@pytest.fixture(scope="module")
def jax_int8_forwards(jax_int8_trees):
    """JAX's int8_packed_forward on seeded packed planes: calibrated -> (its
    tree, the planes, the packed SR)."""
    tree, jcal, _ = jax_int8_trees
    rng = np.random.default_rng(6)
    lst_up = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    ndvi = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    return {cal: (jtree, (lst_up, ndvi),
                  np.asarray(jax_qpacked.int8_packed_forward(jtree, jnp.asarray(lst_up),
                                                             jnp.asarray(ndvi))))
            for cal, jtree in ((True, jcal), (False, tree))}


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_packed_step_matches_jax(stats, jax_int8_steps, calibrated):
    """make_int8_packed_sr_step on JAX's tree carried across, calibrated
    (static scales) or not (dynamic per-sample scales), vs JAX's step."""
    jtree, (lst, ndvi), want = jax_int8_steps[calibrated]
    got = quantized_packed.make_int8_packed_sr_step(stats[0], "cpu")(
        quantized_packed.unpacked_int8_params(jax_tree_to_torch(jax.device_get(jtree))),
        lst, ndvi).numpy()
    assert got.shape == want.shape == (2, 128, 128) and got.dtype == np.float32
    rmse, dmax = _diffs(got, want)
    assert rmse < RMSE_K and dmax < MAX_K, (rmse, dmax)
    assert 250.0 < got.min() and got.max() < 350.0


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_packed_step_takes_jax_packed_tree(stats, jax_int8_steps, calibrated):
    """JAX's packed tree, carried across and passed as it is (as JAX's step
    takes it), runs through the port's step: within the bounds of JAX's
    step, and identical to the step on the tree un-packed beforehand."""
    jtree, (lst, ndvi), want = jax_int8_steps[calibrated]
    tree = jax_tree_to_torch(jax.device_get(jtree))
    assert tree.keys() == {"mid", "packed"}
    step = quantized_packed.make_int8_packed_sr_step(stats[0], "cpu")
    got = step(tree, lst, ndvi)
    rmse, dmax = _diffs(got.numpy(), want)
    assert rmse < RMSE_K and dmax < MAX_K, (rmse, dmax)
    assert torch.equal(got, step(quantized_packed.unpacked_int8_params(tree), lst, ndvi))


def test_int8_packed_step_runs_18_generic_convs(weights, stats, monkeypatch):
    """One batch runs conv_i8_generic 18 times, once for every conv of the
    folded model, on either tree: the five level-0 kernels are unpacked once
    where the step's un-packed tree is built and never by the step on it,
    and five times a call by the step on the packed tree."""
    calls = {"conv": 0, "unpack": 0}
    conv, unpack = quantized.conv_i8_generic, quantized_packed._unpack_conv_weights

    def counted_conv(*a, **kw):
        calls["conv"] += 1
        return conv(*a, **kw)

    def counted_unpack(*a, **kw):
        calls["unpack"] += 1
        return unpack(*a, **kw)

    monkeypatch.setattr(quantized, "conv_i8_generic", counted_conv)
    monkeypatch.setattr(quantized_packed, "_unpack_conv_weights", counted_unpack)
    step = quantized_packed.make_int8_packed_sr_step(stats[0], "cpu")
    tree = quantized_packed.quantize_packed_params(weights[0], "cpu")
    params = quantized_packed.unpacked_int8_params(tree)
    assert calls == {"conv": 0, "unpack": 5}
    lst, ndvi = _patches(5, n=1, size=16)
    first = step(params, lst, ndvi)
    assert calls == {"conv": 18, "unpack": 5}
    second = step(params, lst, ndvi)
    assert calls == {"conv": 36, "unpack": 5}
    assert torch.equal(first, second)
    packed_route = step(tree, lst, ndvi)
    assert calls == {"conv": 54, "unpack": 10}
    assert torch.equal(packed_route, first)


def test_unpacked_int8_params_is_the_int8_tree(weights, stats, jax_int8_trees):
    """unpacked_int8_params of the packed int8 tree is predict --int8's tree
    (quantize_serving_params) leaf for leaf, bit-equal; on a calibrated tree
    every leaf keeps its in_scale."""
    got = quantized_packed.unpacked_int8_params(
        quantized_packed.quantize_packed_params(weights[0], "cpu"))
    assert _assert_trees_equal(got, quantized.quantize_serving_params(weights[0], "cpu")) == 3 * 18
    cal = quantized_packed.unpacked_int8_params(jax_tree_to_torch(
        jax.device_get(jax_int8_trees[1])))
    assert cal["ub3"]["convbloc"]["conv1"]["conv"]["q"].shape == (3, 3, 32, 16)

    def count(node):
        if "q" in node:
            assert node.keys() == {"q", "scale", "bias", "in_scale"}
            return 1
        return sum(count(v) for v in node.values())

    assert count(cal) == 18


def test_int8_packed_forward_matches_jax(stats, jax_int8_forwards):
    """int8_packed_forward on packed planes, on JAX's calibrated tree carried
    across and un-packed, vs JAX's int8_packed_forward on the packed tree:
    the packed SR within the step's bounds (normalised units x std_lst)."""
    jcal, (lst_up, ndvi), want = jax_int8_forwards[True]
    got = quantized_packed.int8_packed_forward(
        quantized_packed.unpacked_int8_params(jax_tree_to_torch(jax.device_get(jcal))),
        torch.from_numpy(lst_up), torch.from_numpy(ndvi)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 4)
    rmse, dmax = _diffs(got * stats[0].std_lst, want * stats[0].std_lst)
    assert rmse < RMSE_K and dmax < MAX_K, (rmse, dmax)


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_packed_forward_takes_jax_packed_tree(stats, jax_int8_forwards, calibrated):
    """int8_packed_forward on JAX's packed tree passed as it is, with JAX's
    c0: within the step's bounds of JAX's forward, and identical to the
    forward on the tree un-packed beforehand."""
    jtree, (lst_up, ndvi), want = jax_int8_forwards[calibrated]
    tree = jax_tree_to_torch(jax.device_get(jtree))
    planes = torch.from_numpy(lst_up), torch.from_numpy(ndvi)
    got = quantized_packed.int8_packed_forward(tree, *planes, c0=16)
    rmse, dmax = _diffs(got.numpy() * stats[0].std_lst, want * stats[0].std_lst)
    assert rmse < RMSE_K and dmax < MAX_K, (rmse, dmax)
    assert torch.equal(got, quantized_packed.int8_packed_forward(
        quantized_packed.unpacked_int8_params(tree), *planes))


@pytest.mark.parametrize("unpacked", [False, True])
def test_int8_packed_forward_rejects_wrong_c0(weights, unpacked):
    """A c0 other than the tree's inbloc width (16) raises, on either tree."""
    tree = quantized_packed.quantize_packed_params(weights[0], "cpu")
    if unpacked:
        tree = quantized_packed.unpacked_int8_params(tree)
    planes = torch.zeros(1, 8, 8, 4), torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="c0=32"):
        quantized_packed.int8_packed_forward(tree, *planes, c0=32)
    assert quantized_packed.int8_packed_forward(tree, *planes, c0=16).shape == (1, 8, 8, 4)


def test_unpack_conv_weights_inverts_packing(rng):
    """The packed kernel's output phase (0, 0) holds every tap of the
    unpacked kernel once: unpacking recovers it exactly."""
    for c_in, c_out in ((2, 16), (32, 16), (16, 1), (3, 5)):
        w = rng.integers(-127, 128, (3, 3, c_in, c_out)).astype(np.float32)
        wp, _ = packed.pack_conv_weights(w, np.zeros(c_out, np.float32))
        got = quantized_packed._unpack_conv_weights(torch.from_numpy(wp.astype(np.int8)))
        np.testing.assert_array_equal(got.numpy(), w.astype(np.int8))


@pytest.mark.parametrize("shape", [(2, 12, 9, 5), (1, 8, 8, 16)])
def test_upsample_bilinear_x2_nhwc_hp_matches_jax(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax_upsample_hp(jnp.asarray(x)))
    got = upsample_bilinear_x2_nhwc_hp(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
