"""The port's int8 serving slice against the JAX package (CPU, Pallas kernels
in interpret mode): weight quantisation, calibration, the whole int8 step
(mid='prow', the default, with both x2 chains, mid='xla', and the
kernels='alt' comparison step), the plain int8 step of predict --int8 with its
parameter tree, and whole-granule prediction with the float32 and int8 steps."""

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
from sifsr_tpu.pallas.conv_px import nhwc_to_rows

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.inference import predict_granule
from sifsr_tpu_torch.kernels.conv_i8 import quantize_activation, quantize_kernel
from sifsr_tpu_torch.models import int8_serving
from sifsr_tpu_torch.models.fused import fold_batchnorm
from sifsr_tpu_torch.models.packed import calibration_record, pack_conv_weights

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")

# The mid='xla' int8 step's end-to-end tolerance vs JAX's mid='xla' step. The kernels
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
        q, s = quantize_kernel(k)
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
    qp, sp = quantize_kernel(pack_conv_weights(k, bias)[0])
    q, s = quantize_kernel(k)
    np.testing.assert_array_equal(sp, np.tile(s, 4))
    np.testing.assert_array_equal(qp, pack_conv_weights(q.astype(np.float32), bias)[0].astype(np.int8))


def test_packed_quantisation_of_split_halves(weights):
    """ub3.conv1's up/skip halves, quantised on their own, as the TPU builder
    does on its packed (3,3,4,32,64) view."""
    k = _folded_kernels(weights[0])[("ub3", "convbloc", "conv1", "conv")]
    wp = pack_conv_weights(k, np.zeros(16, np.float32))[0].reshape(3, 3, 4, 32, 64)
    for packed_half, half in ((wp[:, :, :, :16], k[:, :, :16]), (wp[:, :, :, 16:], k[:, :, 16:])):
        qp, sp = quantize_kernel(packed_half.reshape(3, 3, 64, 64))
        q, s = quantize_kernel(half)
        np.testing.assert_array_equal(sp, np.tile(s, 4))
        want = pack_conv_weights(q.astype(np.float32), np.zeros(16, np.float32))[0]
        np.testing.assert_array_equal(qp, want.astype(np.int8))


def test_calibration_record_matches_jax(rng, weights, stats):
    lst, ndvi = _patches(rng, 2, 32)
    pp = jax.device_get(jax_serving.pack_serving_params(weights[1]))
    jrec, jmid = jax_serving._f32_packed_mirror(pp, lst, ndvi, stats[1])
    rec, mid = calibration_record(weights[0], lst, ndvi, stats[0], device="cpu")
    assert rec.keys() == jrec.keys() and mid.keys() == jmid.keys()
    for k in jrec:
        np.testing.assert_allclose(rec[k], jrec[k], rtol=1e-5, err_msg=k)
    for k in jmid:
        np.testing.assert_allclose(mid[k], jmid[k], rtol=1e-5, err_msg=str(k))


def _jax_record(rng, weights, stats, size=32, up2_impl="mxu"):
    """JAX's calibration record on seeded patches, and JAX's parameters."""
    cal_lst, cal_ndvi = _patches(rng, 2, size)
    pp = jax.device_get(jax_serving.pack_serving_params(weights[1]))
    rec, mid_rec = jax_serving._f32_packed_mirror(pp, cal_lst, cal_ndvi, stats[1])
    jparams = jax_serving.build_pallas_serving_params(weights[1], cal_lst, cal_ndvi, stats[1],
                                                      up2_impl=up2_impl)
    return rec, mid_rec, jparams


def test_int8_step_matches_jax_xla_mid(rng, weights, stats):
    """The slice as a whole: JAX's calibration record goes into both
    builders; the port's int8 step vs make_pallas_sr_step(mid='xla')."""
    rec, mid_rec, jparams = _jax_record(rng, weights, stats)
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu",
                                              lst_size=32)
    lst, ndvi = _patches(rng, 2, 32)
    want = np.asarray(jax_serving.make_pallas_sr_step(stats[1], interpret=True, mid="xla")(
        jparams, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = int8_serving.make_int8_sr_step(stats[0], mid="xla", device="cpu")(
        params, lst, ndvi).numpy()
    assert got.shape == want.shape == (2, 128, 128) and got.dtype == np.float32
    d = got - want
    assert np.sqrt((d ** 2).mean()) <= RMSE_K
    assert np.abs(d).max() <= MAX_K
    assert 250.0 < got.min() and got.max() < 350.0


def _port_phase_mean(params, stats, lst, ndvi):
    """The port's input to the mid chain: kernels A, D and B of the step."""
    from sifsr_tpu_torch.kernels import conv_i8_exact, conv_i8_in1_split, upsample_phases

    def norm(x, mean, std):
        return (torch.from_numpy(x) - torch.tensor(mean)) / torch.tensor(std)

    in1, in2 = params["in1"], params["in2"]
    lst_q = upsample_phases(norm(lst, stats.mean_lst, stats.std_lst)[..., None], 4, "cubic",
                            scale=params["s"]["in1"])[..., 0]
    ndvi_q = quantize_activation(norm(ndvi, stats.mean_ndvi, stats.std_ndvi), in1["in_scale"])
    s1 = conv_i8_in1_split(lst_q, ndvi_q, in1["w"], in1["scale"], in1["bias"])
    return conv_i8_exact(s1, in2["w"], in2["scale"], in2["bias"], pm_scale=params["pm_scale"])[1]


def test_int8_step_matches_jax_prow_mid(rng, weights, stats):
    """The slice as a whole with the default mid chain (kernels G-K): JAX's
    calibration record goes into both builders. The mid chain's int8 output
    (kernel K's, the x2 of ub2 at the up scale) equals JAX's _prow_mid on the
    same input after unpacking its pair rows; the Kelvin output then runs the
    same int8 tail. Expected max|d| is 0 K: the 1e-4 K allows only for the
    order of the outlay's float32 de-normalise fold (scale * std, bias * std
    + mean), which XLA may fuse differently from PyTorch."""
    rec, mid_rec, jparams = _jax_record(rng, weights, stats)
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu",
                                              lst_size=32)
    lst, ndvi = _patches(rng, 2, 32)

    pm = _port_phase_mean(params, stats[0], lst, ndvi)
    got_mid = int8_serving._prow_mid(params["pmid"], pm).numpy()
    want_mid = np.asarray(jax_serving._prow_mid(jparams["pmid"], nhwc_to_rows(
        jnp.asarray(pm.numpy()), 8), 64, True))
    want_mid = want_mid.reshape(2, 64, 64, 2, 2, 16).transpose(0, 1, 3, 2, 4, 5)
    assert got_mid.shape == (2, 128, 128, 16) and got_mid.dtype == np.int8
    np.testing.assert_array_equal(got_mid, want_mid.reshape(2, 128, 128, 16))
    assert np.abs(got_mid.astype(int)).mean() > 2

    want = np.asarray(jax_serving.make_pallas_sr_step(stats[1], interpret=True)(
        jparams, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = int8_serving.make_int8_sr_step(stats[0], device="cpu")(params, lst, ndvi).numpy()
    assert got.shape == want.shape == (2, 128, 128) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4
    assert 250.0 < got.min() and got.max() < 350.0


def _contracted_x2(q, rc, cc, inv):
    """The vpu x2 chain on int8 q (N,h,w,C) with every multiply-add after a
    pass's first term contracted into one FMA (emulated in float64: the
    product of two float32 is exact there), numpy. What XLA:CPU makes of the
    interpreted kernel; the TPU's VPU and the port round each product and
    each sum on their own."""
    f32, f64 = np.float32, np.float64

    def fma(a, b, c):
        return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)

    n, h, w, c = q.shape
    x = q.astype(f32)
    out = np.empty((n, h, 2, w, 2, c), f32)
    for d in range(2):
        r = None
        for j, dl in enumerate((-1, 0, 1)):
            co, xs = rc[d, j][None, :, None, None], np.roll(x, -dl, axis=1)
            r = (co * xs).astype(f32) if r is None else fma(co, xs, r)
        for e in range(2):
            y = None
            for j, dl in enumerate((-1, 0, 1)):
                co, rs = cc[e, j][None, None, :, None], np.roll(r, -dl, axis=2)
                y = (co * rs).astype(f32) if y is None else fma(co, rs, y)
            out[:, :, d, :, e] = y
    y = out.reshape(n, 2 * h, 2 * w, c) * f32(inv)
    return np.clip(np.rint(y), -127, 127).astype(np.int8)


def test_int8_step_vpu_matches_jax(rng, weights, stats, monkeypatch):
    """up2_impl='vpu': the x2 tables are bit-equal to JAX's up2_coeffs, and
    each of the mid chain's three fused x2 stages (kernels I, I, K with the
    float32 chain; sources 16², 32² and the 64² serving tail) is identical to
    the chain's specification: kernel A, upsample_phases(q, 2, 'linear_ac',
    scale=s_up, in_scale=s_mid), on the stage's own conv output q.

    Against JAX's _prow_mid on vpu parameters the mid chain's int8 output is
    identical except where XLA:CPU's contraction shows: at the 64² tail it
    fuses the interpreted kernel's multiply-adds into FMAs even at the
    suite's opt level 0. The test demonstrates that instead of allowing for
    it: every element that differs has a pre-round value, in the port's
    separately rounded chain, within one ulp of a rounding tie (here exactly
    87.5, rounded half-to-even to 88, where the FMA chain lands one ulp
    below), and the same chain with its multiply-adds contracted
    (_contracted_x2, on the port's q) reproduces JAX's output in every
    element. The Kelvin output equals JAX's to 1e-4 K (the outlay fold, as in
    the prow test) outside the 7x7 receptive field of such an element under
    the three tail convs, and stays within one flipped quantum's 0.5 K
    inside."""
    from sifsr_tpu_torch.kernels import conv_px, upsample_phases
    from sifsr_tpu_torch.kernels.resize_phases import phase_passes

    rec, mid_rec, jparams = _jax_record(rng, weights, stats, up2_impl="vpu")
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu",
                                              lst_size=32, up2_impl="vpu")
    for block, leaf, c_out in (("db3", "last", 64), ("ub1", "conv2", 32), ("ub2", "conv2", 16)):
        got, want = params["pmid"][block][leaf], jparams["pmid"][block][leaf]
        assert got["rtab"].dtype == got["ctab"].dtype == torch.float32 and "rm" not in want
        np.testing.assert_array_equal(got["rtab"].numpy(), np.asarray(want["rc"])[..., 0])
        np.testing.assert_array_equal(np.repeat(got["ctab"].numpy(), c_out, axis=2),
                                      np.asarray(want["cc"]))
        assert np.float32(got["inv"]) == np.asarray(want["inv"])
    lst, ndvi = _patches(rng, 2, 32)
    pm = _port_phase_mean(params, stats[0], lst, ndvi)

    stages = []

    def recording(fn):
        def wrapped(x, w, scale, bias, rtab, ctab, inv, relu=True):
            out = fn(x, w, scale, bias, rtab, ctab, inv, relu)
            stages.append((conv_px.conv_prow_plain(x, w, scale, bias, relu), rtab, ctab, inv, out))
            return out
        return wrapped

    monkeypatch.setattr(int8_serving, "conv_prow_up2", recording(conv_px.conv_prow_up2))
    monkeypatch.setattr(int8_serving, "conv_prow_up2_pack",
                        recording(conv_px.conv_prow_up2_pack))
    got_mid = int8_serving._prow_mid(params["pmid"], pm).numpy()
    monkeypatch.undo()
    s = params["s"]
    assert [tuple(st[0].shape) for st in stages] == [(2, 16, 16, 64), (2, 32, 32, 32),
                                                     (2, 64, 64, 16)]
    for (q, _, _, _, out), (s_mid, s_up) in zip(stages, (("m_t3", "m_upt3"), ("m_u1", "m_upu1"),
                                                         ("m_u2", "up"))):
        oracle = upsample_phases(q, 2, "linear_ac", scale=s[s_up], in_scale=s[s_mid])
        np.testing.assert_array_equal(out.numpy(), oracle.numpy(), err_msg=s_mid)
    assert np.abs(got_mid.astype(int)).mean() > 2

    want_mid = np.asarray(jax_serving._prow_mid(jparams["pmid"], nhwc_to_rows(
        jnp.asarray(pm.numpy()), 8), 64, True))
    want_mid = want_mid.reshape(2, 64, 64, 2, 2, 16).transpose(0, 1, 3, 2, 4, 5)
    want_mid = want_mid.reshape(2, 128, 128, 16)
    differs = got_mid != want_mid
    q, rtab, ctab, inv, _ = stages[-1]
    if differs.any():
        pre = (phase_passes(q.to(torch.float32), (-1, 0, 1), rtab, ctab) * float(inv)).numpy()
        v = pre[differs]
        assert np.all(np.abs(np.abs(v - np.floor(v)) - 0.5) <= np.spacing(np.abs(v))), v
        assert np.abs(got_mid.astype(int) - want_mid)[differs].max() == 1
        np.testing.assert_array_equal(
            _contracted_x2(q.numpy(), rtab.numpy(), ctab.numpy(), inv), want_mid)

    want = np.asarray(jax_serving.make_pallas_sr_step(stats[1], interpret=True)(
        jparams, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = int8_serving.make_int8_sr_step(stats[0], device="cpu")(params, lst, ndvi).numpy()
    near = torch.nn.functional.max_pool2d(
        torch.from_numpy(differs.any(-1).astype(np.float32))[:, None], 7, 1, 3)[:, 0].numpy() > 0
    d = np.abs(got - want)
    assert d[~near].max() <= 1e-4, d[~near].max()
    assert d.max() <= MAX_K and near.sum() <= 49 * differs.sum()


@pytest.mark.parametrize("mid", ["prow", "xla"])
def test_alt_step_identical_to_default(rng, weights, stats, mid):
    """kernels='alt' (E for inbloc.conv1, L for the skip concats, F for the
    outlay) on the same parameters: the Kelvin output equals the default
    step's bit for bit."""
    rec, mid_rec, _ = _jax_record(rng, weights, stats, size=16)
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu",
                                              lst_size=16)
    lst, ndvi = _patches(rng, 3, 16)
    want = int8_serving.make_int8_sr_step(stats[0], mid=mid, device="cpu")(params, lst, ndvi)
    got = int8_serving.make_int8_sr_step(stats[0], mid=mid, kernels="alt", device="cpu")(
        params, lst, ndvi)
    assert got.dtype == torch.float32 and got.shape == (3, 64, 64)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert 250.0 < float(got.min()) and float(got.max()) < 350.0


def _quantized_trees(rng, weights, stats, size=16):
    """The --int8 parameter trees of both packages, calibrated on the same
    seeded patches."""
    from sifsr_tpu.models import quantized as jq
    from sifsr_tpu_torch.models import quantized as tq

    cal_lst, cal_ndvi = _patches(rng, 2, size)
    jtree = jq.calibrate_activation_scales(weights[1], jq.quantize_serving_params(weights[1]),
                                           cal_lst, cal_ndvi, stats[1])
    ttree = tq.calibrate_activation_scales(weights[0],
                                           tq.quantize_serving_params(weights[0], "cpu"),
                                           cal_lst, cal_ndvi, stats[0], device="cpu")
    return ttree, jtree


def jax_quantized_tree_to_torch(jtree) -> dict:
    """JAX's calibrated --int8 tree -> the port's (CPU tensors): the state
    carried across for the quantised step."""
    if "q" in jtree:
        return {k: torch.from_numpy(np.array(v)) for k, v in jtree.items()}
    return {k: jax_quantized_tree_to_torch(v) for k, v in jtree.items()}


def test_quantized_tree_matches_jax_leaf_by_leaf(rng, weights, stats):
    """Both --int8 trees are built from the same variables and samples: q
    identical, scale/bias/in_scale to 1e-7 relative (in_scale to 1e-5: it
    is max|x| of a float32 conv output, whose summation order differs)."""
    ttree, jtree = _quantized_trees(rng, weights, stats)
    n = 0

    def walk(t, j, path):
        nonlocal n
        if "q" in j:
            n += 1
            assert t.keys() == j.keys() == {"q", "scale", "bias", "in_scale"}, path
            assert t["q"].dtype == torch.int8 and t["in_scale"].shape == ()
            np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]), err_msg=str(path))
            for k, rtol in (("scale", 1e-7), ("bias", 1e-7), ("in_scale", 1e-5)):
                np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=rtol, atol=1e-9,
                                           err_msg=f"{path} {k}")
            return
        assert t.keys() == j.keys(), path
        for k in j:
            walk(t[k], j[k], path + (k,))

    walk(ttree, jtree, ())
    assert n == 18


@pytest.mark.parametrize("static", [True, False])
def test_quantized_int8_step_matches_jax(rng, weights, stats, static):
    """predict --int8's step vs JAX's make_int8_sr_step on the same tree
    (JAX's, converted), within 1e-3 K: the int8 convs are exact, and what
    differs is float32 summation order in the bicubic / bilinear matmuls and
    the 2x2 means. static=False drops in_scale and takes the dynamic
    per-sample activation scales, held to the same 1e-3 K."""
    from sifsr_tpu.models import quantized as jq
    from sifsr_tpu_torch.models import quantized as tq

    _, jtree = _quantized_trees(rng, weights, stats)
    if not static:
        jtree = jq.quantize_serving_params(weights[1])
    lst, ndvi = _patches(rng, 2, 16)
    want = np.asarray(jq.make_int8_sr_step(stats[1])(jtree, jnp.asarray(lst), jnp.asarray(ndvi)))
    got = tq.make_int8_sr_step(stats[0], "cpu")(jax_quantized_tree_to_torch(jtree), lst,
                                                ndvi).numpy()
    assert got.shape == want.shape == (2, 64, 64) and got.dtype == np.float32
    d = np.abs(got - want)
    assert d.max() <= 1e-3, d.max()
    assert 250.0 < got.min() and got.max() < 350.0


def test_mid_and_up2_impl_are_checked(rng, weights, stats):
    """mid takes 'prow' or 'xla', kernels 'default' or 'alt', up2_impl 'mxu'
    or 'vpu'; a prow step refuses blocks of another size than its
    parameters' x2 tables were built for."""
    with pytest.raises(ValueError, match="mid"):
        int8_serving.make_int8_sr_step(stats[0], mid="bogus", device="cpu")
    with pytest.raises(ValueError, match="kernels"):
        int8_serving.make_int8_sr_step(stats[0], kernels="bogus", device="cpu")
    rec, mid_rec, _ = _jax_record(rng, weights, stats, size=16)
    with pytest.raises(ValueError, match="up2_impl"):
        int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu", lst_size=16,
                                         up2_impl="bogus")
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu",
                                              lst_size=16)
    with pytest.raises(ValueError, match="16"):
        int8_serving.make_int8_sr_step(stats[0], device="cpu")(params, *_patches(rng, 1, 32))


def _granule(rng):
    """A small synthetic granule: 16x16 LST windows, 6 blocks (a last batch
    of 2 at batch 4: JAX pads it, the port does not), one 0 K block masked
    by coverage."""
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


def _predict_granule_int8(rng, weights, stats, mid):
    """Whole-granule prediction with the int8 steps, both calibrated on the
    same (JAX) record at the granule's window size: (port, JAX) mosaics."""
    lst, ndvi, kw = _granule(rng)
    rec, mid_rec, jparams = _jax_record(rng, weights, stats, size=kw["window"])
    params = int8_serving.int8_serving_params(weights[0], rec, mid_rec, device="cpu",
                                              lst_size=kw["window"])
    want = jax_predict_granule(weights[1], lst, ndvi, stats[1],
                               sr_step=jax_serving.make_pallas_sr_step(stats[1], interpret=True,
                                                                       mid=mid),
                               step_params=jparams, **kw)
    got = predict_granule(weights[0], lst, ndvi, stats[0], device="cpu",
                          sr_step=int8_serving.make_int8_sr_step(stats[0], mid=mid,
                                                                 device="cpu"),
                          step_params=params, **kw)
    assert np.all(got[:64, :64] == 0.0)
    return got, want


def test_predict_granule_int8_matches_jax(rng, weights, stats):
    """Whole-granule prediction with the default (prow) int8 steps: the same
    tolerance as test_int8_step_matches_jax_prow_mid."""
    got, want = _predict_granule_int8(rng, weights, stats, "prow")
    assert np.abs(got - want).max() <= 1e-4


def test_predict_granule_int8_xla_matches_jax(rng, weights, stats):
    """Whole-granule prediction with the mid='xla' int8 steps."""
    got, want = _predict_granule_int8(rng, weights, stats, "xla")
    d = got - want
    assert np.sqrt((d ** 2).mean()) <= RMSE_K and np.abs(d).max() <= MAX_K


def test_make_quantized_step_within_int8_contract(rng, weights, stats):
    """predict's own wiring: an int8 step calibrated on a granule's valid
    64x64 blocks stays within the int8 contract of the float32 mosaic
    (RMSE < 0.3 K, max < 1 K). The step is the prow one, bound to 64x64 LST
    blocks, so the granule is served at predict's own window."""
    from sifsr_tpu_torch.cli.predict import make_quantized_step

    lst = (296.0 + 20.0 * rng.random((64, 128))).astype(np.float32)
    ndvi = (0.1 + 0.7 * rng.random((256, 512))).astype(np.float32)
    kw = dict(batch_size=2)
    cal_lst, cal_ndvi = _patches(rng, 1, 64)
    step, qparams = make_quantized_step(weights[0], cal_lst[0], cal_ndvi[0], stats[0],
                                        use_pallas=True, device="cpu")
    got = predict_granule(weights[0], lst, ndvi, stats[0], device="cpu", sr_step=step,
                          step_params=qparams, **kw)
    ref = predict_granule(weights[0], lst, ndvi, stats[0], compute_dtype=torch.float32,
                          device="cpu", **kw)
    d = got - ref
    assert got.shape == (256, 512)
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
    int8 contract (RMSE < 0.3 K, max < 1 K) on those blocks. JAX's default
    step (mid='prow') clips the same way: the port stays within the slice's
    tolerance of it there too (each package calibrates on its own here, and
    float32 summation order in the calibration mirrors can move a scale by
    an ulp and flip an int8 quantum). This pins the calibration-coverage
    fault recorded in ROADMAP.md; a rule that covers the granule changes
    it."""
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
    want = np.asarray(jax_serving.make_pallas_sr_step(stats[1], interpret=True)(
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
