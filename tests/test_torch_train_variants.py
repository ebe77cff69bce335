"""Training's two model options against the JAX package: the fused
replicate pads (``pad_impl='fused'``: a zero-padded conv plus border-ring
corrections) and the ConvTranspose decoder (``bilinear=False``), on the same
seeded numpy inputs and weights carried across with ``models.convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from sifsr_tpu.models.unet import _DN
from sifsr_tpu.models.unet import ModelB2 as JaxModelB2
from sifsr_tpu.models.unet import _replicate_conv_fused
from sifsr_tpu.train.state import create_train_state as jax_create_train_state
from sifsr_tpu.train.step import make_train_step as jax_make_train_step

from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from sifsr_tpu_torch.models.unet import ModelB2, replicate_conv_fused
from sifsr_tpu_torch.train import create_train_state, make_train_step

from test_torch_train import WEIGHTS, _leaves

MEAN, STD, ALPHA, GAMMA = 295.0, 10.0, 0.99, -0.5
NARROW = (8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_train.py: Adam's first step
    amplifies summation-order noise where a gradient is near its eps."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_explicit(x, w):
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    return lax.conv_general_dilated(xp, w, (1, 1), "VALID", dimension_numbers=_DN,
                                    precision=lax.Precision.HIGHEST)


def _torch_explicit(x, w):
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), w)


@pytest.mark.parametrize("shape", [(2, 6, 7, 3, 5), (1, 5, 5, 1, 1), (3, 8, 6, 4, 2),
                                   (1, 3, 3, 2, 2), (2, 1, 4, 3, 2)])
def test_fused_conv_forward_matches_jax_and_explicit(shape):
    """tests/test_pad_impl.py's bound, 2e-6 (rtol and atol), against JAX's
    _replicate_conv_fused and the explicit conv; the interior is the
    explicit conv's, bit for bit."""
    n, h, w_, cin, k = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, h, w_, cin)).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, k)).astype(np.float32)
    want = np.asarray(_replicate_conv_fused(jnp.asarray(x), jnp.asarray(w),
                                            lax.Precision.HIGHEST)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = replicate_conv_fused(xt, wt).numpy()
    explicit = _torch_explicit(xt, wt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, explicit, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(got[:, :, 1:-1, 1:-1], explicit[:, :, 1:-1, 1:-1])


def test_fused_conv_gradients_match_jax_and_explicit():
    """Gradients of <fused(x, w), cot> w.r.t. x and w within 3e-5 of JAX's
    fused form and of the explicit conv (tests/test_pad_impl.py's bound)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 6, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    cot = rng.standard_normal((2, 7, 6, 4)).astype(np.float32)

    def jgrad(fn):
        return jax.grad(lambda x, w: jnp.vdot(fn(x, w), jnp.asarray(cot)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))

    jx, jw = jgrad(lambda x, w: _replicate_conv_fused(x, w, lax.Precision.HIGHEST))
    ex, ew = jgrad(_jax_explicit)
    grads = []
    for fn in (replicate_conv_fused, _torch_explicit):
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
        wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
        (fn(xt, wt) * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
        grads.append((xt.grad.numpy().transpose(0, 2, 3, 1), wt.grad.numpy().transpose(2, 3, 1, 0)))
    (gx, gw), (tx, tw) = grads
    for got, want in ((gx, jx), (gw, jw), (gx, ex), (gw, ew), (gx, tx), (gw, tw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("shape", [(2, 3, 5, 4, 4), (1, 2, 1, 3, 2), (1, 1, 3, 3, 1),
                                   (2, 2, 3, 1, 2), (1, 1, 1, 1, 1)])
def test_fused_conv_gradcheck_float64(shape):
    """The fused conv's written-out backward (the zero-padded conv's
    gradients plus the border lines' and corners') is the derivative of its
    forward: a float64 gradcheck, with the bias, down to one-row and
    one-column images, where the border lines overlap."""
    n, c, h, w_, k = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, c, h, w_, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(k, c, 3, 3, dtype=torch.float64, generator=g, requires_grad=True)
    b = torch.randn(k, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(replicate_conv_fused, (x, w, b))


def test_fused_model_keeps_parameters_and_matches_explicit_forward():
    """pad_impl changes forward only: the same state-dict keys (strict load of
    the published weights), and a forward within the JAX test's bound of
    1e-4 / 1e-5 of the explicit model, in eval and train mode."""
    sd = load_variables(WEIGHTS)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 64, 64, 2)).astype(np.float32))
    outs = {}
    for impl in ("explicit", "fused"):
        model = ModelB2(pad_impl=impl)
        assert list(model.state_dict()) == list(ModelB2().state_dict())
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[impl] = (model.eval()(x).numpy(), model.train()(x).numpy())
    for got, want in zip(outs["fused"], outs["explicit"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="pad_impl"):
        ModelB2(pad_impl="copy")


def test_fused_step_tracks_explicit_in_float32_and_bf16():
    """One step with fused and with explicit pads from the same seeded init.
    float32: first losses within tests/test_pad_impl.py's bounds (rtol 1e-4
    / atol 1e-5), gradients within 1e-3 (relative L2). bf16 under autocast
    (on the CPU): the fused step is no further from the explicit bf16 step
    than 3x the explicit bf16 step is from the explicit float32 one, in loss
    and in gradients (at 64² bf16 moves the gradients ~18 % off float32; the
    fused form rounds each border sum twice); gradients and parameters stay
    float32."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(5)).items()}
    out = {}
    for impl, dtype in (("explicit", torch.float32), ("fused", torch.float32),
                        ("explicit", torch.bfloat16), ("fused", torch.bfloat16)):
        model = ModelB2(downchannels=NARROW, pad_impl=impl, dtype=dtype,
                        precision="highest" if dtype == torch.float32 else "default")
        state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(5),
                                   device="cpu")
        _, m = make_train_step(model, "predef_filters", ALPHA, GAMMA, MEAN, STD,
                               with_metrics=False)(state, batch)
        grads = torch.cat([p.grad.ravel() for p in model.parameters()])
        assert grads.dtype == torch.float32 and torch.isfinite(grads).all()
        assert all(p.dtype == torch.float32 for p in model.parameters())
        out[impl, dtype] = (float(m["loss"]), grads)

    def apart(a, b):
        (la, ga), (lb, gb) = out[a], out[b]
        return abs(la - lb), float((ga - gb).norm() / gb.norm())

    f32, bf16 = torch.float32, torch.bfloat16
    dl, dg = apart(("fused", f32), ("explicit", f32))
    assert dl <= 1e-5 + 1e-4 * abs(out["explicit", f32][0]) and dg < 1e-3
    dl, dg = apart(("fused", bf16), ("explicit", bf16))
    ref_l, ref_g = apart(("explicit", bf16), ("explicit", f32))
    assert dl <= 3 * ref_l and dg <= 3 * ref_g, (dl, ref_l, dg, ref_g)


def _seeded_jax_variables(model, seed=0, hw=64):
    """A JAX model's init with its BatchNorm statistics and biases moved off
    their defaults, so every term of a forward is exercised."""
    v = jax.tree.map(np.asarray, model.init(jax.random.key(seed), jnp.zeros((1, hw, hw, 2)),
                                            train=False))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.abs(rng.normal(1.0, 0.2, a.shape)) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32), v["batch_stats"])
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          v["params"])
    return {"params": params, "batch_stats": stats}


def _batch(rng, n=2, hw=64):
    return {"lst": rng.normal(size=(n, hw // 4, hw // 4, 1)).astype(np.float32),
            "lst_up": rng.normal(size=(n, hw, hw, 1)).astype(np.float32),
            "ndvi": rng.normal(size=(n, hw, hw, 1)).astype(np.float32)}


def _steps_match(kw, remat, seed):
    """One predef_filters train step of the port and of JAX from the same
    variables (a seeded JAX init), at narrow widths: metrics within 1e-5
    (relative past 1), BatchNorm statistics within 5e-5, the parameters'
    q999 within 1e-4 (tests/test_torch_train.py's bound) and, wherever
    |gradient| >= 1e-5, within 2e-5; no update apart by more than 2 lr.

    Adam's first update lr*g/(|g|+eps) turns float32 summation noise in a
    small gradient into a difference of up to 2 lr. On these seeded
    variables ~0.1 % of the gradients lie below 1e-6 and ~1 % below 1e-5,
    and the explicit pads' step, port against JAX, is 2e-3 apart in the
    first and 9e-5 in the second (the golden step's threshold, 1e-6, is for
    a converged model); at 1e-5 and up both steps agree to 3e-7."""
    jax_model = JaxModelB2(downchannels=NARROW, **kw)
    variables = _seeded_jax_variables(jax_model, seed)
    batch = _batch(np.random.default_rng(seed))
    jstate = jax_create_train_state(jax_model, 1e-3, variables=variables)
    jstate, want = jax_make_train_step(jax_model, "predef_filters", ALPHA, GAMMA, MEAN, STD,
                                       remat=remat)(jstate, {k: jnp.asarray(v)
                                                             for k, v in batch.items()})
    model = ModelB2(downchannels=NARROW, **kw)
    state = create_train_state(model, 1e-3, variables=from_jax_variables(variables), device="cpu")
    state, got = make_train_step(model, "predef_filters", ALPHA, GAMMA, MEAN, STD, remat=remat)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.keys() == want.keys()
    for k in got:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(1.0, abs(float(want[k]))), k
    want_sd = from_jax_variables(jax.device_get({"params": jstate.params,
                                                 "batch_stats": jstate.batch_stats}))
    sd = model.state_dict()
    diffs, grads = [], []
    for name, p in model.named_parameters():
        diffs.append(np.abs(p.detach().numpy() - want_sd[name].numpy()).ravel())
        grads.append(np.abs(p.grad.numpy()).ravel())
    diffs, grads = np.concatenate(diffs), np.concatenate(grads)
    assert (grads >= 1e-5).mean() > 0.9
    assert float(np.quantile(diffs, 0.999)) < 1e-4
    assert float(diffs[grads >= 1e-5].max()) < 2e-5
    assert float(diffs.max()) <= 2e-3 + 1e-6
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert float((sd[k] - v).abs().max()) < 5e-5, k


@pytest.mark.parametrize("remat", [False, True])
def test_fused_train_step_matches_jax(remat):
    _steps_match(dict(pad_impl="fused"), remat, seed=1)


def test_convtranspose_train_step_matches_jax():
    _steps_match(dict(bilinear=False), False, seed=2)


def test_convtranspose_upblock_matches_flax():
    """ub1.up with the weights from_jax_variables carries across equals
    flax's ConvTranspose on the same kernel. Without the spatial flip the
    stride-2, kernel-2 transpose conv still runs and only permutes each 2x2
    output block, so the values are compared, and the unflipped kernel is
    shown to differ."""
    import flax.linen as nn

    jax_model = JaxModelB2(downchannels=NARROW, bilinear=False)
    variables = _seeded_jax_variables(jax_model, 3)
    up = variables["params"]["ub1"]["up"]
    assert up["kernel"].shape == (2, 2, 64, 32)
    x = np.random.default_rng(3).standard_normal((2, 5, 7, 64)).astype(np.float32)
    want = np.asarray(nn.ConvTranspose(32, (2, 2), strides=(2, 2), padding="VALID",
                                       precision=lax.Precision.HIGHEST).apply(
        {"params": up}, jnp.asarray(x)))
    model = ModelB2(downchannels=NARROW, bilinear=False)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = model.ub1.up(xt).numpy().transpose(0, 2, 3, 1)
        unflipped = F.conv_transpose2d(xt, torch.from_numpy(
            np.ascontiguousarray(up["kernel"].transpose(2, 3, 0, 1))), torch.from_numpy(up["bias"]),
            stride=2).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 14, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(unflipped - want).max() > 0.1


def test_convtranspose_model_forward_and_tree_roundtrip():
    """ModelB2(bilinear=False) at narrow widths: the reference's keys
    (ub*.up.weight/bias, db3 at full width, DoubleConvs with mid = out), its
    forward in eval and train mode against JAX's within the float32 forward
    bound of the port (rtol 1e-4 / atol 5e-5, chip_smoke.py phase 4), and the
    from_jax_variables / to_jax_variables round trip exact."""
    jax_model = JaxModelB2(downchannels=NARROW, bilinear=False)
    variables = _seeded_jax_variables(jax_model, 4)
    sd = from_jax_variables(variables)
    model = ModelB2(downchannels=NARROW, bilinear=False)
    model.load_state_dict(sd, strict=True)
    assert [k for k in model.state_dict() if ".up." in k] == [
        "ub1.up.weight", "ub1.up.bias", "ub2.up.weight", "ub2.up.bias", "ub3.up.weight",
        "ub3.up.bias"]
    assert model.ub1.up.weight.shape == (64, 32, 2, 2)
    assert model.db3.lastconv[0].weight.shape[0] == 64          # d[3] // 1
    assert model.ub1.convbloc.bloc[0].weight.shape == (32, 64, 3, 3)   # mid = out = 32
    back = to_jax_variables(model.state_dict())
    want_leaves, got_leaves = dict(_leaves(variables)), dict(_leaves(back))
    assert got_leaves.keys() == want_leaves.keys()
    for k in want_leaves:
        np.testing.assert_array_equal(got_leaves[k], want_leaves[k])

    x = np.random.default_rng(4).standard_normal((2, 64, 64, 2)).astype(np.float32)
    for train in (False, True):
        want = jax_model.apply(variables, jnp.asarray(x), train=train,
                               mutable=["batch_stats"] if train else False)
        want = np.asarray(want[0] if train else want)
        with torch.no_grad():
            got = model.train(train)(torch.from_numpy(x)).numpy()
        assert np.abs(want).max() > 0.05
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


def test_convtranspose_init_is_seeded():
    """A fresh bilinear=False model draws its transposed convs from the
    generator too (LeCun-normal over 4 x in channels), as its convs."""
    a, b = (create_train_state(ModelB2(bilinear=False), 1e-3,
                               generator=torch.Generator().manual_seed(9), device="cpu")
            for _ in range(2))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    w = a.model.ub1.up.weight.detach()              # (128, 64, 2, 2): fan_in 128 * 4
    assert abs(float(w.std()) * np.sqrt(128 * 4) - 1.0) < 0.05
    assert float(a.model.ub1.up.bias.abs().max()) == 0.0
