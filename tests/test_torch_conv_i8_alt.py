"""Kernels E (conv_i8_in1) and F (conv_i8_outlay) of the port (plain versions,
on the CPU) against the Pallas kernels in interpret mode, at the packed
shapes of tests/test_conv_i8_pallas.py.

The TPU kernels take the 2x2 space-to-depth packed input and return pair rows
(E) or 8-lane phase rows (F); the port's take and return the unpacked NHWC
tensors those stand for. E's int8 output must be identical to the Pallas
kernel's and to kernel D's on the de-interleaved planes. F's float32 output
is held to the Pallas kernel at atol 1e-4 / rtol 1e-5, the tolerance of
tests/test_conv_i8_pallas.py::test_conv_i8_outlay (both compute
float(acc) * scale + bias with two roundings; the tolerance covers an FMA on
either side), and must be identical to the generic conv's plain version on
the same operands.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.models.packed import _depth_to_space, _space_to_depth, pack_conv_weights
from sifsr_tpu.pallas import conv_i8 as pallas_conv

from sifsr_tpu_torch.kernels import conv_i8_in1, conv_i8_in1_split, conv_i8_outlay
from sifsr_tpu_torch.kernels.conv_i8 import conv_i8_generic_plain


def _pack_i8(w):
    wp, _ = pack_conv_weights(w.astype(np.float32), np.zeros(w.shape[-1], np.float32))
    return wp.astype(np.int8)


@pytest.mark.parametrize("hp,wp", [(16, 32), (8, 16)])
def test_conv_i8_in1_matches_pallas_and_split(rng, hp, wp):
    """Kernel E on the channel-interleaved (lst, ndvi) tensor: identical int8
    to Pallas conv_i8_in1 on the packed input, and to kernel D."""
    n, h, w = 2, 2 * hp, 2 * wp
    x = rng.integers(-127, 128, (n, h, w, 2)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, 2, 16)).astype(np.int8)
    scale = (0.0005 + 0.001 * rng.random(16)).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    w432 = pallas_conv.pack_in1_weights(_pack_i8(k))
    want = pallas_conv.conv_i8_in1(
        _space_to_depth(jnp.asarray(x)), jnp.asarray(w432), jnp.asarray(np.tile(scale, 64)),
        jnp.asarray(np.tile(bias, 64)), hp, wp, interpret=True)
    want = np.asarray(_depth_to_space(want.reshape(n, hp, wp, 64), 16))
    args = [torch.from_numpy(a) for a in (k, scale, bias)]
    got = conv_i8_in1(torch.from_numpy(x), *args).numpy()
    assert got.dtype == np.int8 and got.shape == (n, h, w, 16)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want.astype(int)).mean() > 2                 # not a saturated/zero case
    split = conv_i8_in1_split(torch.from_numpy(x[..., 0].copy()),
                              torch.from_numpy(x[..., 1].copy()), *args).numpy()
    np.testing.assert_array_equal(got, split)


@pytest.mark.parametrize("hp,wp", [(32, 32), (16, 48)])
def test_conv_i8_outlay_matches_pallas_and_generic(rng, hp, wp):
    """Kernel F: the fine SR image of the Pallas outlay kernel (its documented
    lane -> fine-pixel map), borders and corners included."""
    n, h, w = 2, 2 * hp, 2 * wp
    x = rng.integers(-127, 128, (n, h, w, 16)).astype(np.int8)
    k = rng.integers(-20, 21, (3, 3, 16, 1)).astype(np.int8)
    scale = np.asarray([0.03 * 0.004 * 9.7], np.float32)       # in_scale * w scale * std
    bias = np.asarray([0.31 * 9.7 + 301.5], np.float32)        # bias * std + mean
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
