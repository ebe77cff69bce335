"""Kernels D (conv_i8_in1_split) and the outlay (conv_i8_outlay, the generic
conv at 16 -> 1) of the port at the accumulator sizes their tensor-core
epilogues must hold: plain versions, on the CPU, against the Pallas kernels
in interpret mode, on saturating operands.

On the card both kernels convert int32 accumulators to float32 with an
exact float/integer sequence that holds below 2^22 (D's largest is
18 * 127^2 = 290,322, the outlay's 144 * 127^2 = 2,322,576); these cases put
the accumulators near those bounds, and tests/test_torch_cuda.py holds the
kernels to the same plain versions there. D's int8 output must be identical
to the Pallas kernel's; the outlay's float32 output is held to the Pallas
kernel at atol 1e-4 / rtol 1e-5 (the tolerance of
tests/test_torch_conv_i8_alt.py::test_conv_i8_outlay_matches_pallas_and_generic)
and must be identical to the generic conv's plain version.

D's single k32 chunk takes K in the order k = 2 * tap + channel, the HWIO
weights flattened, so the kernel reads its B fragments from the weights as
they are; the last test holds that order: an im2col in it times the
weights reshaped to (18, 16) gives the plain conv's accumulators.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.models.packed import _depth_to_space, _space_to_depth, pack_conv_weights
from sifsr_tpu.pallas import conv_i8 as pallas_conv

from sifsr_tpu_torch.kernels import conv_i8_in1_split, conv_i8_outlay
from sifsr_tpu_torch.kernels.conv_i8 import conv3x3_i32, conv_i8_generic_plain


def _pack_i8(w):
    wp, _ = pack_conv_weights(w.astype(np.float32), np.zeros(w.shape[-1], np.float32))
    return wp.astype(np.int8)


def _saturating(rng, n, h, w, cin, cout, mode):
    """int8 x (n,h,w,cin) and HWIO weights (3,3,cin,cout) at +-127: 'max' all
    +127; 'alternating' a checkerboard of signs over pixels and channels
    (weights over taps and channels), so that every interior accumulator is
    at the largest magnitude with a sign that alternates from pixel to
    pixel; 'coherent' the signs of x and w aligned over the input channels,
    x constant in sign on 4x4 pixel blocks with one value in 32 flipped."""
    if mode == "max":
        return np.full((n, h, w, cin), 127, np.int8), np.full((3, 3, cin, cout), 127, np.int8)
    if mode == "alternating":
        yy, xx, cc = np.ogrid[:h, :w, :cin]
        x = np.broadcast_to(127 * (-1) ** (yy + xx + cc), (n, h, w, cin))
        tt, ci, co = np.ogrid[:9, :cin, :cout]
        wt = (127 * (-1) ** (tt + ci + co)).reshape(3, 3, cin, cout)
        return np.ascontiguousarray(x, np.int8), wt.astype(np.int8)
    s, t = rng.choice([-1, 1], cin), rng.choice([-1, 1], cout)
    r = np.kron(rng.choice([-1, 1], (n, h // 4 + 1, w // 4 + 1)), np.ones((1, 4, 4)))[:, :h, :w]
    f = np.where(rng.random((n, h, w, cin)) < 1 / 32, -1, 1)
    x = (127 * r[..., None] * s * f).astype(np.int8)
    wt = np.ascontiguousarray(np.broadcast_to(127 * s[:, None] * t[None, :], (3, 3, cin, cout)),
                              np.int8)
    return x, wt


def _max_acc(x, wt):
    return int(conv3x3_i32(torch.from_numpy(x), torch.from_numpy(wt)).abs().max())


@pytest.mark.parametrize("mode", ["max", "alternating", "coherent"])
def test_conv_i8_in1_split_saturating_matches_pallas(rng, mode):
    """Kernel D on LST / NDVI planes at +-127 with +-127 weights, scales that
    put the outputs mid-range: identical int8 to the Pallas kernel."""
    n, h = 2, 32
    x, w = _saturating(rng, n, h, h, 2, 16, mode)
    assert _max_acc(x, w) >= 2 ** 18                         # 18 * 127^2 = 290,322 at most
    scale = (40.0 / (18 * 127.0 ** 2) * (0.5 + rng.random(16))).astype(np.float32)
    bias = rng.normal(0.0, 5.0, 16).astype(np.float32)
    lst, ndvi = np.ascontiguousarray(x[..., 0]), np.ascontiguousarray(x[..., 1])
    w432 = pallas_conv.in1_split_weights(pallas_conv.pack_in1_weights(_pack_i8(w)))
    want = pallas_conv.conv_i8_in1_split(
        _space_to_depth(jnp.asarray(lst[..., None])), _space_to_depth(jnp.asarray(ndvi[..., None])),
        jnp.asarray(w432), jnp.asarray(np.tile(scale, 64)), jnp.asarray(np.tile(bias, 64)),
        h // 2, h // 2, interpret=True)
    want = np.asarray(_depth_to_space(want.reshape(n, h // 2, h // 2, 64), 16))
    got = conv_i8_in1_split(*map(torch.from_numpy, (lst, ndvi, w, scale, bias))).numpy()
    assert got.dtype == np.int8 and got.shape == (n, h, h, 16)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want.astype(int)).mean() > 2                 # not a saturated/zero case


@pytest.mark.parametrize("mode", ["max", "coherent"])
def test_conv_i8_outlay_saturating_matches_pallas(rng, mode):
    """Kernel F on 16 channels at +-127 with +-127 weights and the Kelvin
    de-normalise folded into scale and bias, as the serving step folds it:
    the Pallas kernel's fine image within its test's tolerance, the generic
    conv's plain version bit for bit."""
    n, hp, wp = 2, 16, 16
    h, w = 2 * hp, 2 * wp
    x, k = _saturating(rng, n, h, w, 16, 1, mode)
    assert _max_acc(x, k) >= 2 ** 21                         # 144 * 127^2 = 2,322,576 at most
    scale = np.asarray([20.0 / (144 * 127.0 ** 2)], np.float32)
    bias = np.asarray([301.5], np.float32)
    wm, wc = pallas_conv.pack_outlay_weights(_pack_i8(k))
    olf = pallas_conv.conv_i8_outlay(
        _space_to_depth(jnp.asarray(x)), jnp.asarray(wm), jnp.asarray(wc),
        jnp.asarray(np.tile(scale, 8)), jnp.asarray(np.tile(bias, 8)), hp, wp, interpret=True)
    want = np.asarray(olf).reshape(n, hp, wp // 2, 2, 2, 2).transpose(
        0, 1, 4, 2, 3, 5).reshape(n, h, w)
    tx, tk, ts, tb = (torch.from_numpy(a) for a in (x, k, scale, bias))
    got = conv_i8_outlay(tx, tk, ts, tb).numpy()
    assert got.dtype == np.float32 and got.shape == (n, h, w)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(got, conv_i8_generic_plain(tx, tk, ts, tb, relu=False)
                                  .numpy()[..., 0])
    assert np.abs(want - 301.5).max() > 15.0                   # the accumulators reach the output


@pytest.mark.parametrize("n,h,w", [(2, 16, 24), (1, 3, 5), (1, 1, 2)],
                         ids=["random", "small", "one_row"])
def test_conv_i8_in1_k_order_is_hwio(rng, n, h, w):
    """D's k order: rows of the 3x3 replicate-clamped neighbourhood with k =
    2 * tap + channel (tap = 3 dy + dx), times the HWIO weights reshaped to
    (18, 16), equal the plain conv's int32 accumulators; on images whose
    every pixel is at a border as well."""
    x = rng.integers(-128, 128, (n, h, w, 2)).astype(np.int8)
    wt = rng.integers(-128, 128, (3, 3, 2, 16)).astype(np.int8)
    ry = np.clip(np.arange(h)[:, None] + np.arange(-1, 2)[None, :], 0, h - 1)   # (h, dy)
    rx = np.clip(np.arange(w)[:, None] + np.arange(-1, 2)[None, :], 0, w - 1)   # (w, dx)
    cols = x[:, ry[:, None, :, None], rx[None, :, None, :]]       # (n, h, w, dy, dx, ch)
    got = cols.reshape(n, h, w, 18).astype(np.int64) @ wt.reshape(18, 16).astype(np.int64)
    want = conv3x3_i32(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    np.testing.assert_array_equal(got, want)
