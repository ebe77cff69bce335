"""The port's int8 serving slice against the JAX package (CPU, Pallas kernels
in interpret mode): weight quantisation, calibration, the whole int8 step
(mid='xla') and whole-granule prediction with both steps."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sifsr_tpu.cli.predict import load_variables as jax_load_variables
from sifsr_tpu.data.statistics import Statistics as JaxStatistics
from sifsr_tpu.inference import predict_granule as jax_predict_granule
from sifsr_tpu.models import pallas_serving as jax_serving
from sifsr_tpu.models.quantized import _quantize_kernel as jax_quantize_kernel
from sifsr_tpu.models.unet import ModelB2 as JaxModelB2

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.inference import predict_granule
from sifsr_tpu_torch.models import int8_serving
from sifsr_tpu_torch.models.fused import fold_batchnorm
from sifsr_tpu_torch.models.packed import pack_conv_weights
from sifsr_tpu_torch.models.quantized import _quantize_kernel

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")

# The int8 step's end-to-end tolerance vs JAX's mid='xla' step. The kernels
# are bit-exact against the Pallas kernels; what may differ is float32
# summation order in the XLA mid chain (the 2x2 means, the bilinear einsums,
# the calibration convs), which can flip an int8 requantisation by one
# quantum. One flipped quantum moves the Kelvin output by well under
# 0.5 K locally and leaves the RMSE orders below 0.02 K.
RMSE_K, MAX_K = 0.02, 0.5


@pytest.fixture(scope="module")
def weights():
    return (load_variables(WEIGHTS),
            jax_load_variables(WEIGHTS, "modelB", JaxModelB2()))


@pytest.fixture(scope="module")
def stats():
    return Statistics.from_json(STATS_JSON), JaxStatistics.from_json(STATS_JSON)


def _patches(rng, n, size):
    lst = (296.0 + 20.0 * rng.random((n, size, size))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((n, 4 * size, 4 * size))).astype(np.float32)
    return lst, ndvi


def _folded_kernels(sd):
    folded = fold_batchnorm(sd)
    out = {}

    def walk(node, path):
        if "kernel" in node:
            out[path] = node["kernel"].numpy()
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(folded, ())
    return out


def test_quantize_kernel_bit_equal(rng, weights):
    kernels = list(_folded_kernels(weights[0]).values())
    kernels.append(rng.normal(size=(3, 3, 8, 5)).astype(np.float32))
    kernels.append(np.zeros((3, 3, 2, 3), np.float32))        # zero channel -> scale 1
    for k in kernels:
        q, s = _quantize_kernel(k)
        jq, js = jax_quantize_kernel(k)
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("layer", [("inbloc", "conv1", "conv"), ("inbloc", "conv2", "conv"),
                                   ("ub3", "convbloc", "conv2", "conv"),
                                   ("outlay", "conv")])
def test_packed_quantisation_equals_unpacked(weights, layer):
    """Each packed output phase sees each of the 9 original taps exactly once
    (the rest are zeros), so quantising the packed kernel gives the packed
    form of the quantised unpacked kernel, with the same per-channel scales:
    the port's unpacked int8 convs run the TPU kernels' weights exactly."""
    k = _folded_kernels(weights[0])[layer]
    bias = np.zeros(k.shape[-1], np.float32)
    qp, sp = _quantize_kernel(pack_conv_weights(k, bias)[0])
    q, s = _quantize_kernel(k)
    np.testing.assert_array_equal(sp, np.tile(s, 4))
    np.testing.assert_array_equal(qp, pack_conv_weights(q.astype(np.float32), bias)[0].astype(np.int8))


def test_packed_quantisation_of_split_halves(weights):
    """ub3.conv1's up/skip halves, quantised on their own, as the TPU builder
    does on its packed (3,3,4,32,64) view."""
    k = _folded_kernels(weights[0])[("ub3", "convbloc", "conv1", "conv")]
    wp = pack_conv_weights(k, np.zeros(16, np.float32))[0].reshape(3, 3, 4, 32, 64)
    for packed_half, half in ((wp[:, :, :, :16], k[:, :, :16]), (wp[:, :, :, 16:], k[:, :, 16:])):
        qp, sp = _quantize_kernel(packed_half.reshape(3, 3, 64, 64))
        q, s = _quantize_kernel(half)
        np.testing.assert_array_equal(sp, np.tile(s, 4))
        want = pack_conv_weights(q.astype(np.float32), np.zeros(16, np.float32))[0]
        np.testing.assert_array_equal(qp, want.astype(np.int8))


def test_calibration_record_matches_jax(rng, weights, stats):
    lst, ndvi = _patches(rng, 2, 32)
    pp = jax.device_get(jax_serving.pack_serving_params(weights[1]))
    jrec, jmid = jax_serving._f32_packed_mirror(pp, lst, ndvi, stats[1])
    rec, mid = int8_serving.calibrate(weights[0], lst, ndvi, stats[0], device="cpu")
    assert rec.keys() == jrec.keys() and mid.keys() == jmid.keys()
    for k in jrec:
        np.testing.assert_allclose(rec[k], jrec[k], rtol=1e-5, err_msg=k)
    for k in jmid:
        np.testing.assert_allclose(mid[k], jmid[k], rtol=1e-5, err_msg=str(k))


def test_int8_step_matches_jax_xla_mid(rng, weights, stats):
    """The slice as a whole: JAX's calibration record goes into both
    builders; the port's int8 step vs make_pallas_sr_step(mid='xla')."""
    cal_lst, cal_ndvi = _patches(rng, 2, 32)
    pp = jax.device_get(jax_serving.pack_serving_params(weights[1]))
    rec, mid_rec = jax_serving._f32_packed_mirror(pp, cal_lst, cal_ndvi, stats[1])
    jparams = jax_serving.build_pallas_serving_params(weights[1], cal_lst, cal_ndvi, stats[1])
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu")

    lst, ndvi = _patches(rng, 2, 32)
    want = np.asarray(jax_serving.make_pallas_sr_step(stats[1], interpret=True, mid="xla")(
        jparams, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = int8_serving.make_int8_sr_step(stats[0], device="cpu")(params, lst, ndvi).numpy()
    assert got.shape == want.shape == (2, 128, 128) and got.dtype == np.float32
    d = got - want
    assert np.sqrt((d ** 2).mean()) <= RMSE_K
    assert np.abs(d).max() <= MAX_K
    assert 250.0 < got.min() and got.max() < 350.0


def test_mid_prow_not_ported(stats):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        int8_serving.make_int8_sr_step(stats[0], mid="prow", device="cpu")


def _granule(rng):
    """A small synthetic granule: 16x16 LST windows, 6 blocks (a zero-padded
    tail batch at batch 4), one 0 K block masked by coverage."""
    lst = (296.0 + 20.0 * rng.random((32, 48))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((128, 192))).astype(np.float32)
    lst[:16, :16] = 0.0
    return lst, ndvi, dict(batch_size=4, window=16, coverage=0.05)


def test_predict_granule_f32_matches_jax(rng, weights, stats):
    """Whole-granule prediction with the float32 step vs JAX's."""
    lst, ndvi, kw = _granule(rng)
    want = jax_predict_granule(weights[1], lst, ndvi, stats[1], compute_dtype=jnp.float32,
                               pad_impl="explicit", **kw)
    got = predict_granule(weights[0], lst, ndvi, stats[0], compute_dtype=torch.float32,
                          device="cpu", **kw)
    assert got.shape == (128, 192)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    assert np.all(got[:64, :64] == 0.0) and np.all(got[64:] > 250.0)


def test_predict_granule_int8_matches_jax(rng, weights, stats):
    """Whole-granule prediction with the int8 steps, both calibrated on the
    same (JAX) record, vs JAX's predict_granule with mid='xla'."""
    lst, ndvi, kw = _granule(rng)
    cal_lst, cal_ndvi = _patches(rng, 2, 32)
    jparams = jax_serving.build_pallas_serving_params(weights[1], cal_lst, cal_ndvi, stats[1])
    pp = jax.device_get(jax_serving.pack_serving_params(weights[1]))
    rec, mid_rec = jax_serving._f32_packed_mirror(pp, cal_lst, cal_ndvi, stats[1])
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu")
    want = jax_predict_granule(weights[1], lst, ndvi, stats[1],
                               sr_step=jax_serving.make_pallas_sr_step(stats[1], interpret=True,
                                                                       mid="xla"),
                               step_params=jparams, **kw)
    got = predict_granule(weights[0], lst, ndvi, stats[0], device="cpu",
                          sr_step=int8_serving.make_int8_sr_step(stats[0], device="cpu"),
                          step_params=params, **kw)
    d = got - want
    assert np.sqrt((d ** 2).mean()) <= RMSE_K and np.abs(d).max() <= MAX_K
    assert np.all(got[:64, :64] == 0.0)


def test_make_quantized_step_within_int8_contract(rng, weights, stats):
    """predict's own wiring: an int8 step calibrated on a granule's valid
    64x64 blocks stays within the int8 contract of the float32 mosaic
    (RMSE < 0.3 K, max < 1 K)."""
    from sifsr_tpu_torch.cli.predict import make_quantized_step

    lst, ndvi, kw = _granule(rng)
    cal_lst, cal_ndvi = _patches(rng, 1, 64)
    step, qparams = make_quantized_step(weights[0], cal_lst[0], cal_ndvi[0], stats[0],
                                        use_pallas=True, device="cpu")
    got = predict_granule(weights[0], lst, ndvi, stats[0], device="cpu", sr_step=step,
                          step_params=qparams, **kw)
    ref = predict_granule(weights[0], lst, ndvi, stats[0], compute_dtype=torch.float32,
                          device="cpu", **kw)
    d = (got - ref)[64:]
    assert np.sqrt((d ** 2).mean()) < 0.3 and np.abs(d).max() < 1.0
    with pytest.raises(ValueError, match="fully-valid"):
        make_quantized_step(weights[0], np.zeros((64, 64), np.float32), cal_ndvi[0], stats[0],
                            use_pallas=True, device="cpu")


def test_overlap_blending_matches_jax(rng, weights, stats):
    lst = (296.0 + 20.0 * rng.random((32, 32))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((128, 128))).astype(np.float32)
    kw = dict(batch_size=4, window=16, overlap=4)
    want = jax_predict_granule(weights[1], lst, ndvi, stats[1], compute_dtype=jnp.float32,
                               pad_impl="explicit", **kw)
    got = predict_granule(weights[0], lst, ndvi, stats[0], compute_dtype=torch.float32,
                          device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)


def test_first_block_calibration_shared_with_jax(weights, stats):
    """predict's calibration rule, shared by both packages: scales come from
    the granule's first 8 fully-valid 64x64 blocks. On a granule whose last
    block row holds a steep front that the first 8 blocks lack, activations
    there pass the calibrated range and clip, and the int8 step leaves the
    int8 contract (RMSE < 0.3 K, max < 1 K) on those blocks. JAX's step
    (mid='xla') clips the same way: the port stays within the slice's
    tolerance of it there too. This pins the calibration-coverage fault
    recorded in ROADMAP.md; a rule that covers the granule changes it."""
    from sifsr_tpu.cli.predict import make_quantized_step as jax_make_quantized_step
    from sifsr_tpu_torch.cli.predict import make_quantized_step
    from sifsr_tpu_torch.inference import make_sr_step, tile_granule
    from sifsr_tpu_torch.models.fused import InferenceModelB2

    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, 192, dtype=np.float32),
                         np.linspace(0, 1, 256, dtype=np.float32), indexing="ij")
    front = np.where(yy > 0.67, 18.0 * np.sin(2 * np.pi * 6 * (xx + yy)), 0.0)
    lst = 302.0 + 3.0 * np.sin(2 * np.pi * xx) + front + rng.normal(0, 0.3, xx.shape)
    ndvi = 0.45 + 0.3 * np.sin(6 * np.pi * np.linspace(0, 1, 768))[:, None] \
        + rng.normal(0, 0.02, (768, 1024))
    lst = np.clip(lst, 290.0, 320.0).astype(np.float32)
    ndvi = np.clip(ndvi, 0.1, 0.8).astype(np.float32)

    step, qparams = make_quantized_step(weights[0], lst, ndvi, stats[0], use_pallas=True,
                                        device="cpu")
    _, jparams = jax_make_quantized_step(weights[1], lst, ndvi, stats[1], use_pallas=True)
    lst_b, ndvi_b, _ = tile_granule(lst, ndvi)
    far = (lst_b[10:], ndvi_b[10:])                    # two blocks after the first 8
    got = step(qparams, *far).numpy()
    want = np.asarray(jax_serving.make_pallas_sr_step(stats[1], interpret=True, mid="xla")(
        jparams, *map(jnp.asarray, far)))
    # the float32 step, held to JAX's in test_torch_model.py
    ref = make_sr_step(stats[0], torch.float32, "cpu")(
        InferenceModelB2.from_variables(weights[0]), *far).numpy()

    def rmse(d):
        return float(np.sqrt((d ** 2).mean()))

    d = got - want
    assert rmse(d) <= RMSE_K and np.abs(d).max() <= MAX_K, (rmse(d), np.abs(d).max())
    for out in (got, want):
        assert rmse(out - ref) > 0.3 and np.abs(out - ref).max() > 1.0, \
            (rmse(out - ref), np.abs(out - ref).max())
