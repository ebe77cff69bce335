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

from sifsr_tpu_torch.kernels import resize_phases
from sifsr_tpu_torch.kernels import (
    conv_i8_exact,
    conv_i8_exact_dual,
    conv_i8_generic,
    conv_i8_in1_split,
    upsample_phases,
)
from sifsr_tpu_torch.models.quantized import int8_conv

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


@pytest.mark.parametrize("factor,kind,size,c", [
    (4, "cubic", 32, 1), (2, "linear_ac", 64, 16),
    pytest.param(4, "cubic", (40, 36), 3, id="4-cubic-40x36-3"),
    pytest.param(2, "linear_ac", (40, 36), 3, id="2-linear_ac-40x36-3")])
@pytest.mark.parametrize("quantise", [True, False])
def test_upsample_phases_matches_pallas(rng, factor, kind, size, c, quantise):
    """Kernel A at the serving step's two call sites (LST cubic x4, ub3's
    align-corners x2), and at an odd shape (H != W, 3 channels): int8
    identical, float32 within the repo's atol."""
    h, w = size if isinstance(size, tuple) else (size, size)
    x = (3.0 * rng.standard_normal((N, h, w, c))).astype(np.float32)
    scale = 0.025 if quantise else None
    want = np.asarray(phases_to_nhwc(pallas_upsample(
        jnp.asarray(x), factor, kind, out_dtype=jnp.int8 if quantise else jnp.float32,
        scale=scale, interpret=True)))
    got = upsample_phases(torch.from_numpy(x), factor, kind, scale=scale).numpy()
    assert got.shape == (N, factor * h, factor * w, c)
    if quantise:
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


# (H, W, C, factor, kind): the serving calls, odd shapes, the widest row the
# one-row-a-block kernel took (W*C*4 = 227 KB) and rows around the 32 KB step
_LAUNCH_SHAPES = [(64, 64, 1, 4, "cubic"), (128, 128, 16, 2, "linear_ac"),
                  (40, 36, 3, 4, "cubic"), (40, 36, 3, 2, "linear_ac"),
                  (40, 37, 16, 2, "linear_ac"), (9, 7, 5, 3, "cubic"), (1, 1, 1, 4, "cubic"),
                  (2, 3632, 16, 2, "linear_ac"), (3, 908, 64, 2, "linear_ac"),
                  (1, 58112, 1, 4, "cubic"), (16, 512, 16, 2, "linear_ac"),
                  (16, 513, 16, 2, "linear_ac"), (8, 8192, 1, 4, "cubic"),
                  (8, 8193, 1, 4, "cubic"), (256, 256, 16, 2, "linear_ac")]


@pytest.mark.parametrize("h,w,c,factor,kind", _LAUNCH_SHAPES)
def test_upsample_phases_launch_fits(h, w, c, factor, kind):
    """Kernel A's launch (``_launch_shape``, whose R the wrapper passes to
    csrc/resize_phases.cu): R >= 1 output rows a block, the blocks of an image cover its f*H rows, and a
    block's shared memory (R rows of W*C floats) stays within the card's
    227 KB for every row the one-row-a-block kernel took (W*C*4 <= 227 KB);
    R > 1 only within 32 KB. At the serving calls: R = 32 (cubic x4 of 64²,
    2,592 blocks at batch 324) and R = 4 (the x2 of 128² x 16, 20,736)."""
    card_smem = 227 * 1024   # shared memory a block can use on the H100
    rows, blocks, smem = resize_phases._launch_shape(h, w, c, factor)
    assert rows >= 1 and rows & (rows - 1) == 0 and rows <= 32
    assert (blocks - 1) * rows < factor * h <= blocks * rows
    assert w * c * 4 <= card_smem   # the widest rows of the sweep
    assert smem == rows * w * c * 4 <= card_smem
    assert rows == 1 or smem <= 32 * 1024
    assert rows == 32 or 2 * smem > 32 * 1024
    if w <= 512:   # the tables of a narrow row: at most the kernel's 8 taps
        deltas, rc, cc = resize_phases._tables(h, w, factor, kind)
        assert 1 <= len(deltas) <= 8 and rc.shape[1] == cc.shape[1] == len(deltas)
    serving = {(64, 64, 1): (32, 8), (128, 128, 16): (4, 64)}
    if (h, w, c) in serving:
        assert (rows, blocks) == serving[(h, w, c)]
        assert 324 * blocks == {32: 2592, 4: 20736}[rows]


@pytest.mark.parametrize("h,w,c,factor,kind,scale", [(64, 64, 1, 4, "cubic", 0.02),
                                                     (32, 32, 16, 2, "linear_ac", None),
                                                     (2, 3632, 16, 2, "linear_ac", 0.025)])
def test_upsample_phases_passes_the_launch_rows_to_the_entry(rng, monkeypatch, h, w, c, factor,
                                                             kind, scale):
    """The host side of kernel A's launch, with the library and the CUDA
    stream stood in for: the entry gets the tables, the shape, and as R the
    rows of _launch_shape (the rule test_upsample_phases_launch_fits holds),
    then the epilogue's 1/scale, the output type and the output."""
    calls = []

    class Lib:
        def sifsr_upsample_phases(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(resize_phases, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 7})())
    x = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32))
    out = resize_phases._on_card(x, factor, kind, scale, None)
    ((xp, rcp, ccp, deltas, n_taps, *shape, inv, out_int8, outp, stream),) = calls
    want_deltas, rc, cc = resize_phases._device_tables(h, w, factor, kind, x.device)
    assert xp == x.data_ptr() and outp == out.data_ptr() and stream == 7
    assert list(deltas[:n_taps]) == list(want_deltas)
    assert shape == [factor, 2, h, w, c, resize_phases._launch_shape(h, w, c, factor)[0]]
    assert out.shape == (2, factor * h, factor * w, c)
    assert (out.dtype, out_int8, inv) == ((torch.int8, 1, resize_phases._inv_scale(scale))
                                          if scale else (torch.float32, 0, 1.0))
    with pytest.raises(ValueError, match="contiguous"):
        resize_phases._on_card(x.transpose(1, 2), factor, kind, scale, None)


def _b_operands(rng, sat):
    """x (N,H,H,16) and w (3,3,16,16) int8 with scale/bias; saturating: every
    input and weight at +-127 (random signs; accumulators of 127^2 *
    sqrt(144) typically, up to 2,322,576), scales that keep the outputs
    mid-range."""
    if not sat:
        return (rng.integers(-127, 128, (N, H, H, 16)).astype(np.int8),
                rng.integers(-40, 41, (3, 3, 16, 16)).astype(np.int8), *_scales(rng))
    x = (127 * rng.choice([-1, 1], (N, H, H, 16))).astype(np.int8)
    w = (127 * rng.choice([-1, 1], (3, 3, 16, 16))).astype(np.int8)
    scale = (40.0 / (127.0 ** 2 * 12.0) * (0.5 + rng.random(16))).astype(np.float32)
    return x, w, scale, rng.normal(0.0, 5.0, 16).astype(np.float32)


@pytest.mark.parametrize("with_pm,sat", [(True, False), (False, False), (True, True),
                                         (False, True)],
                         ids=["True", "False", "saturating-True", "saturating-False"])
def test_conv_i8_exact_matches_pallas(rng, with_pm, sat):
    """Kernel B (inbloc.conv2 with the fused phase mean; ub3.conv2 without),
    also with every input and weight at +-127."""
    x, w, scale, bias = _b_operands(rng, sat)
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


@pytest.mark.parametrize("sat", [False, True], ids=["random", "saturating"])
def test_conv_i8_exact_dual_matches_pallas(rng, sat):
    """Kernel C (ub3.conv1 over concat(up, s0), concat never formed), also
    with every input and weight of both halves at +-127."""
    x, wx, sx, bias = _b_operands(rng, sat)
    z, wz, sz, _ = _b_operands(rng, sat)
    wmx, wcx = pallas_conv.pack_row_tap_weights(_pack_i8(wx))
    wmz, wcz = pallas_conv.pack_row_tap_weights(_pack_i8(wz))
    want = pallas_conv.conv_i8_exact_dual(
        _s2d(x), _s2d(z), *map(jnp.asarray, (wmx, wcx, wmz, wcz, np.tile(sx, 8),
                                             np.tile(sz, 8), np.tile(bias, 8))),
        H // 2, H // 2, interpret=True)
    want = np.asarray(_depth_to_space(want, 16))
    got = conv_i8_exact_dual(*map(torch.from_numpy, (x, z, wx, wz, sx, sz, bias)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want.astype(int)).mean() > 5


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
    got = int8_conv(torch.from_numpy(x), {
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
