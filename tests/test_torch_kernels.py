"""The port's kernels (plain versions, on the CPU) against the Pallas kernels.

Each Pallas kernel runs in interpret mode, as tests/test_conv_i8_pallas.py
runs it. The TPU kernels take the 2x2 space-to-depth packed pair-row form;
the port's take the unpacked NHWC tensors those stand for, so the inputs go
through models/packed._space_to_depth (and the weights through
pack_conv_weights) on the JAX side. int8 outputs must be identical: the
port keeps every rounding point and summation order of the TPU kernels, and
the suite's XLA:CPU runs without FMA contraction (conftest.py opt level 0),
so nothing in the arithmetic differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.models.packed import _depth_to_space, _space_to_depth, pack_conv_weights
from sifsr_tpu.models.quantized_packed import _conv_i8_mid as jax_conv_i8_mid
from sifsr_tpu.pallas import conv_i8 as pallas_conv
from sifsr_tpu.pallas.resize_phases import phases_to_nhwc
from sifsr_tpu.pallas.resize_phases import upsample_phases as pallas_upsample

from sifsr_tpu_torch.kernels import (
    conv_i8_exact,
    conv_i8_exact_dual,
    conv_i8_generic,
    conv_i8_in1_split,
    upsample_phases,
)
from sifsr_tpu_torch.models.quantized_packed import _conv_i8_mid

N, H = 2, 64  # SR-level size of an LST 32² block: 128² at 256² scale / 4


def _pack_i8(w):
    """Unpacked int8 HWIO kernel -> the packed int8 kernel the TPU form runs."""
    wp, _ = pack_conv_weights(w.astype(np.float32), np.zeros(w.shape[-1], np.float32))
    return wp.astype(np.int8)


def _s2d(x):
    return _space_to_depth(jnp.asarray(x))


def _scales(rng, k=16):
    return ((0.0005 + 0.001 * rng.random(k)).astype(np.float32),
            rng.normal(size=k).astype(np.float32))


@pytest.mark.parametrize("factor,kind,size,c", [(4, "cubic", 32, 1), (2, "linear_ac", 64, 16)])
@pytest.mark.parametrize("quantise", [True, False])
def test_upsample_phases_matches_pallas(rng, factor, kind, size, c, quantise):
    """Kernel A at the serving step's two call sites (LST cubic x4, ub3's
    align-corners x2): int8 identical, float32 within the repo's atol."""
    x = (3.0 * rng.standard_normal((N, size, size, c))).astype(np.float32)
    scale = 0.025 if quantise else None
    want = np.asarray(phases_to_nhwc(pallas_upsample(
        jnp.asarray(x), factor, kind, out_dtype=jnp.int8 if quantise else jnp.float32,
        scale=scale, interpret=True)))
    got = upsample_phases(torch.from_numpy(x), factor, kind, scale=scale).numpy()
    assert got.shape == (N, factor * size, factor * size, c)
    if quantise:
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("with_pm", [True, False])
def test_conv_i8_exact_matches_pallas(rng, with_pm):
    """Kernel B (inbloc.conv2 with the fused phase mean; ub3.conv2 without)."""
    x = rng.integers(-127, 128, (N, H, H, 16)).astype(np.int8)
    w = rng.integers(-40, 41, (3, 3, 16, 16)).astype(np.int8)
    scale, bias = _scales(rng)
    wm, wc = pallas_conv.pack_row_tap_weights(_pack_i8(w))
    phase_mean = np.float32(0.7)
    out = pallas_conv.conv_i8_exact(
        _s2d(x), jnp.asarray(wm), jnp.asarray(wc), jnp.asarray(np.tile(scale, 8)),
        jnp.asarray(np.tile(bias, 8)), H // 2, H // 2,
        phase_mean=phase_mean if with_pm else None, pm_dtype=jnp.int8, interpret=True)
    y_want = out[0] if with_pm else out
    y_want = np.asarray(_depth_to_space(y_want, 16))
    pm_scale = float(phase_mean / np.float32(4.0)) if with_pm else None
    got = conv_i8_exact(*map(torch.from_numpy, (x, w, scale, bias)), pm_scale=pm_scale)
    y_got = got[0] if with_pm else got
    np.testing.assert_array_equal(y_got.numpy(), y_want)
    assert np.abs(y_want.astype(int)).mean() > 5          # not a saturated/zero case
    if with_pm:
        pm_want = np.asarray(out[1]).reshape(N, H // 2, H // 2, 16)
        np.testing.assert_array_equal(got[1].numpy(), pm_want)


def test_conv_i8_exact_dual_matches_pallas(rng):
    """Kernel C (ub3.conv1 over concat(up, s0), concat never formed)."""
    x = rng.integers(-127, 128, (N, H, H, 16)).astype(np.int8)
    z = rng.integers(-127, 128, (N, H, H, 16)).astype(np.int8)
    wx = rng.integers(-40, 41, (3, 3, 16, 16)).astype(np.int8)
    wz = rng.integers(-40, 41, (3, 3, 16, 16)).astype(np.int8)
    sx, bias = _scales(rng)
    sz, _ = _scales(rng)
    wmx, wcx = pallas_conv.pack_row_tap_weights(_pack_i8(wx))
    wmz, wcz = pallas_conv.pack_row_tap_weights(_pack_i8(wz))
    want = pallas_conv.conv_i8_exact_dual(
        _s2d(x), _s2d(z), *map(jnp.asarray, (wmx, wcx, wmz, wcz, np.tile(sx, 8),
                                             np.tile(sz, 8), np.tile(bias, 8))),
        H // 2, H // 2, interpret=True)
    got = conv_i8_exact_dual(*map(torch.from_numpy, (x, z, wx, wz, sx, sz, bias)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_depth_to_space(want, 16)))


def test_conv_i8_in1_split_matches_pallas(rng):
    """Kernel D (inbloc.conv1 over separate LST / NDVI int8 planes)."""
    lst = rng.integers(-127, 128, (N, H, H)).astype(np.int8)
    ndvi = rng.integers(-127, 128, (N, H, H)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 2, 16)).astype(np.int8)
    scale, bias = _scales(rng)
    w432 = pallas_conv.in1_split_weights(pallas_conv.pack_in1_weights(_pack_i8(w)))
    want = pallas_conv.conv_i8_in1_split(
        _s2d(lst[..., None]), _s2d(ndvi[..., None]), jnp.asarray(w432),
        jnp.asarray(np.tile(scale, 64)), jnp.asarray(np.tile(bias, 64)), H // 2, H // 2,
        interpret=True)
    want = np.asarray(_depth_to_space(want.reshape(N, H // 2, H // 2, 64), 16))
    got = conv_i8_in1_split(*map(torch.from_numpy, (lst, ndvi, w, scale, bias)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin,cout,relu", [(16, 16, True), (128, 64, True), (16, 1, False)])
def test_conv_i8_mid_matches_jax(rng, cin, cout, relu):
    """The mid chain's int8 conv (quantise by division, int32 sums, float32
    dequantise) vs the JAX package's XLA form. Both run op by op with the
    same roundings, so the float32 outputs are identical; (128, 64) is
    ub1.conv1, whose sums pass 2^24."""
    x = (2.0 * rng.standard_normal((N, 16, 16, cin))).astype(np.float32)
    q = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale, bias = _scales(rng, cout)
    in_scale = np.float32(0.02)
    want = np.asarray(jax_conv_i8_mid(jnp.asarray(x), {
        "q": jnp.asarray(q), "scale": jnp.asarray(scale), "bias": jnp.asarray(bias),
        "in_scale": jnp.float32(in_scale)}, relu))
    got = _conv_i8_mid(torch.from_numpy(x), {
        "q": torch.from_numpy(q), "scale": torch.from_numpy(scale),
        "bias": torch.from_numpy(bias), "in_scale": torch.tensor(in_scale)}, relu)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_i8_generic_is_the_replicate_conv(rng):
    """The plain generic conv equals a direct loop over the replicate-padded
    taps (int64 sums), the definition the CUDA kernel implements."""
    x = rng.integers(-127, 128, (1, 5, 7, 4)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 4, 2)).astype(np.int8)
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    acc = sum(np.einsum("nhwc,ck->nhwk", xp[:, dy:dy + 5, dx:dx + 7], w[dy, dx].astype(np.int64))
              for dy in range(3) for dx in range(3))
    scale = np.full(2, 0.5, np.float32)
    bias = np.zeros(2, np.float32)
    got = conv_i8_generic(*map(torch.from_numpy, (x, w, scale, bias)), relu=False)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32) * np.float32(0.5))
