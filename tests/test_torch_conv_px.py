"""Kernels G-L of the port (plain versions, on the CPU) against the Pallas
kernels of sifsr_tpu/pallas/conv_px.py in interpret mode, at the shapes of
tests/test_conv_px_pallas.py.

The TPU kernels take and return p-pixel rows, split half-planes, e-major
pixel groups and space-to-depth pair rows; the port's take the unpacked
NHWC tensors those stand for. The JAX outputs are unpacked the way the JAX
package's own tests unpack them (rows_to_nhwc, planes_to_nhwc, the
argsort(up2_perm) un-permutation, the pair-row reshape). int8 outputs must
be identical: the port keeps every rounding point of the Pallas kernels,
and the suite's XLA:CPU runs without FMA contraction (conftest.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.pallas import conv_px as jax_px
from sifsr_tpu.pallas.conv_px import nhwc_to_rows, planes_to_nhwc, rows_to_nhwc, up2_perm

from sifsr_tpu_torch.kernels import conv_px


def _rand_case(rng, n, h, w, c, c_out):
    x_q = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    k = rng.normal(size=(3, 3, c, c_out)).astype(np.float32) * 0.2
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    return x_q, k, bias


def _sat_case(rng, n, h, w, c, c_out):
    """Every input at +-127 and every quantised weight at +-127 (random
    signs): accumulators of 127^2 * sqrt(9 c) typically, up to 9 * 64 *
    127^2 = 9,290,304 at 64 channels."""
    x_q = (127 * rng.choice([-1, 1], (n, h, w, c))).astype(np.int8)
    k = (0.2 * rng.choice([-1.0, 1.0], (3, 3, c, c_out))).astype(np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    return x_q, k, bias


# input scales that keep the saturating cases' outputs mid-range
SAT_S_IN = {"x": 0.003, "z": 0.006, "up2": 0.006}


def _coherent_case(rng, n, h, w, c, c_out):
    """Every input and weight at +-127 with aligned signs, so that the
    accumulators pass 2^22 at 32 and 64 channels (the largest possible,
    9 * c * 127^2, is 4,645,152 and 9,290,304 there): w = 0.2 * s[ci] * t[co]
    (quantised to +-127), x = 127 * s[ci] * r * f with r = +-1 constant on
    4x4 pixel blocks and f = -1 for one value in 32, so that inside a block
    |acc| is about 15/16 of the largest."""
    s, t = rng.choice([-1, 1], c), rng.choice([-1, 1], c_out)
    r = np.kron(rng.choice([-1, 1], (n, h // 4 + 1, w // 4 + 1)), np.ones((1, 4, 4)))[:, :h, :w]
    f = np.where(rng.random((n, h, w, c)) < 1 / 32, -1, 1)
    x_q = (127 * r[..., None] * s * f).astype(np.int8)
    k = np.ascontiguousarray(np.broadcast_to(0.2 * s[:, None] * t[None, :], (3, 3, c, c_out)),
                             np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    return x_q, k, bias


def _coherent_s_in(c, s_out):
    """The input scale that maps the largest accumulator of a coherent case
    to 90 after the epilogue (weights' scale 0.2 / 127; s_out the output
    scale, or 1 / post_scale)."""
    return 90.0 * s_out / (9.0 * c * 127.0 * 0.2)


def _leaf(k, bias, s_in, s_out=None, post_scale=1.0):
    """The port's leaf as CPU tensors."""
    leaf = conv_px.prow_leaf(k, bias, s_in, s_out, post_scale)
    return [torch.from_numpy(leaf[key]) for key in ("w", "scale", "bias")]


def _up2_tables(h, w, s_mid, s_up):
    rnum, cnum, inv = conv_px.up2_coeffs_mxu(h, w, s_mid, s_up)
    return torch.from_numpy(rnum), torch.from_numpy(cnum), inv


def _assert_identical(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(want.astype(int)).mean() > 2            # not a saturated/zero case


_PROW_CASES = [(8, 16, 16, 16, 32), (4, 32, 32, 16, 16), (2, 64, 64, 8, 8), (2, 64, 32, 8, 16)]


@pytest.mark.parametrize(
    "p,c,c_out,h,w,sat",
    [(*case, False) for case in _PROW_CASES] + [(*case, True) for case in _PROW_CASES[:3]],
    ids=["-".join(map(str, case)) for case in _PROW_CASES]
    + ["saturating-" + "-".join(map(str, case)) for case in _PROW_CASES[:3]])
def test_conv_prow_matches_pallas(rng, p, c, c_out, h, w, sat):
    """Kernel G at the three mid-chain geometries and a narrowing conv, and
    at the three with every input and weight at +-127 (accumulators past
    2^22 at 32 and 64 channels)."""
    x, k, bias = (_coherent_case if sat else _rand_case)(rng, 3, h, w, c, c_out)
    s_in = _coherent_s_in(c, 0.07) if sat else 0.11
    want = rows_to_nhwc(jax_px.conv_prow(
        nhwc_to_rows(jnp.asarray(x), p), jax_px.prow_leaf(k, bias, p, s_in=s_in, s_out=0.07),
        p, c, c_out, h, w, interpret=True), h, w, c_out)
    got = conv_px.conv_prow(torch.from_numpy(x), *_leaf(k, bias, s_in, 0.07))
    _assert_identical(got.numpy(), want)


def test_conv_prow_residual_matches_pallas(rng):
    """Kernel G with the fused residual add (res.conv2 of a DownBlock)."""
    p, c, h, w = 8, 16, 16, 32
    x, k, bias = _rand_case(rng, 2, h, w, c, c)
    v0 = rng.integers(-127, 128, (2, h, w, c), dtype=np.int8)
    res_sc = np.float32(0.2 / 0.15)
    leaf = jax_px.prow_leaf(k, bias, p, s_in=0.2, s_out=None, post_scale=1 / 0.15)
    leaf["res_sc"] = jnp.full((p * c,), res_sc)
    want = rows_to_nhwc(jax_px.conv_prow(
        nhwc_to_rows(jnp.asarray(x), p), leaf, p, c, c, h, w,
        residual=nhwc_to_rows(jnp.asarray(v0), p), interpret=True), h, w, c)
    got = conv_px.conv_prow(torch.from_numpy(x), *_leaf(k, bias, 0.2, None, 1 / 0.15),
                            residual=torch.from_numpy(v0), res_sc=float(res_sc))
    _assert_identical(got.numpy(), want)


@pytest.mark.parametrize("p,c,h,w", [(8, 16, 16, 32), (4, 32, 16, 16), (2, 64, 8, 8)])
def test_conv_prow_residual_saturating_matches_pallas(rng, p, c, h, w):
    """Kernel G with the fused residual add at db1's, db2's and db3's
    channel counts, every input, weight and residual value at +-127
    (accumulators past 2^22 at 32 and 64 channels); the residual's scale
    keeps its share mid-range."""
    x, k, bias = _coherent_case(rng, 2, h, w, c, c)
    v0 = (127 * rng.choice([-1, 1], (2, h, w, c))).astype(np.int8)
    s_in, post = _coherent_s_in(c, 0.15), 1 / 0.15
    res_sc = np.float32(0.02 / 0.15)
    leaf = jax_px.prow_leaf(k, bias, p, s_in=s_in, s_out=None, post_scale=post)
    leaf["res_sc"] = jnp.full((p * c,), res_sc)
    want = rows_to_nhwc(jax_px.conv_prow(
        nhwc_to_rows(jnp.asarray(x), p), leaf, p, c, c, h, w,
        residual=nhwc_to_rows(jnp.asarray(v0), p), interpret=True), h, w, c)
    got = conv_px.conv_prow(torch.from_numpy(x), *_leaf(k, bias, s_in, None, post),
                            residual=torch.from_numpy(v0), res_sc=float(res_sc))
    _assert_identical(got.numpy(), want)


@pytest.mark.parametrize("fold", [False, True])
def test_conv_prow_split_and_fold_match_pallas(rng, fold):
    """Kernel G's other layouts: the split half-plane epilogue (p*c_out >
    128) and the folded-row prologue (doubled p) are the same conv."""
    if fold:
        p, c, c_out, h, w = 8, 32, 16, 8, 16
        x, k, bias = _rand_case(rng, 2, h, w, c, c_out)
        want = rows_to_nhwc(jax_px.conv_prow(
            nhwc_to_rows(jnp.asarray(x), p // 2), jax_px.prow_leaf(k, bias, p, 0.11, 0.07),
            p, c, c_out, h, w, fold=2, interpret=True), h, w, c_out)
    else:
        p, c, c_out, h, w = 8, 16, 32, 16, 32
        x, k, bias = _rand_case(rng, 2, h, w, c, c_out)
        lo, hi = jax_px.conv_prow(
            nhwc_to_rows(jnp.asarray(x), p), jax_px.prow_leaf(k, bias, p, 0.11, 0.07),
            p, c, c_out, h, w, split=True, interpret=True)
        want = planes_to_nhwc(lo, hi, h, w, p, c_out)
    got = conv_px.conv_prow(torch.from_numpy(x), *_leaf(k, bias, 0.11, 0.07))
    _assert_identical(got.numpy(), want)


_POOL_CASES = [(8, 16, 32, 16, 32), (4, 32, 64, 8, 16)]


@pytest.mark.parametrize(
    "p,c,c_out,h,w,sat",
    [(*case, False) for case in _POOL_CASES] + [(*case, True) for case in _POOL_CASES],
    ids=["-".join(map(str, case)) for case in _POOL_CASES]
    + ["saturating-" + "-".join(map(str, case)) for case in _POOL_CASES])
def test_conv_prow_split_pool_matches_pallas(rng, p, c, c_out, h, w, sat):
    """Kernel H: the skip at full resolution and the exact 2x2 pool of the
    requantised int8, in NHWC; also with every input and weight at +-127
    (accumulators past 2^22 at 32 channels in)."""
    s_out, s_next = 0.09, 0.06
    pool_sc = np.float32(s_out / (4 * s_next))
    x, k, bias = (_coherent_case if sat else _rand_case)(rng, 2, h, w, c, c_out)
    s_in = _coherent_s_in(c, s_out) if sat else 0.13
    leaf = jax_px.prow_leaf(k, bias, p, s_in=s_in, s_out=s_out)
    leaf["pool_sc"] = jnp.full((128,), pool_sc)
    lo, hi, pooled = jax_px.conv_prow_split_pool(nhwc_to_rows(jnp.asarray(x), p), leaf, p, c,
                                                 c_out, h, w, interpret=True)
    skip, pool = conv_px.conv_prow_split_pool(torch.from_numpy(x), *_leaf(k, bias, s_in, s_out),
                                              float(pool_sc))
    _assert_identical(skip.numpy(), planes_to_nhwc(lo, hi, h, w, p, c_out))
    _assert_identical(pool.numpy(), np.asarray(pooled).reshape(2, h // 2, w // 2, c_out))


@pytest.mark.parametrize("p,c,c_out,p_out,h,w,fold,sat", [
    (2, 64, 64, 2, 8, 16, 1, False),      # db3.last-like
    (4, 64, 32, 4, 8, 16, 2, False),      # ub1.conv2-like (folded input rows)
    (2, 64, 64, 2, 8, 16, 1, True),       # every input and weight at +-127
], ids=["2-64-64-2-8-16-1", "4-64-32-4-8-16-2", "saturating-2-64-64-2-8-16-1"])
def test_conv_prow_up2_matches_pallas(rng, p, c, c_out, p_out, h, w, fold, sat):
    """Kernel I, integer-exact row mix (up2_impl='mxu'), in natural pixel
    order after undoing the e-major groups."""
    s_mid, s_up = 0.12, 0.2
    x, k, bias = (_sat_case if sat else _rand_case)(rng, 2, h, w, c, c_out)
    s_in = SAT_S_IN["up2"] if sat else 0.17
    leaf = jax_px.prow_leaf(k, bias, p, s_in=s_in, s_out=s_mid)
    _, rm, cc, inv = jax_px.up2_coeffs_mxu(h, w, c_out, s_mid, s_up)
    leaf.update(rm=jnp.asarray(rm), cc=jnp.asarray(cc), inv=jnp.asarray(inv))
    want = jax_px.conv_prow_up2(nhwc_to_rows(jnp.asarray(x), p // fold), leaf, p, c, c_out,
                                p_out, h, w, fold=fold, interpret=True)
    inv_perm = np.argsort(np.asarray(up2_perm(p_out)))
    want = np.asarray(want).reshape(2, 2 * h, (2 * w) // p_out, p_out, c_out)
    want = want[:, :, :, inv_perm, :].reshape(2, 2 * h, 2 * w, c_out)
    got = conv_px.conv_prow_up2(torch.from_numpy(x), *_leaf(k, bias, s_in, s_mid),
                                *_up2_tables(h, w, s_mid, s_up))
    _assert_identical(got.numpy(), want)


def _dual_case(rng, h, w, c, sat):
    """x, kx, bias, z, kz and the two input scales of a dual-conv case."""
    make = _sat_case if sat else _rand_case
    x, kx, bias = make(rng, 2, h, w, c, c)
    z, kz, _ = make(rng, 2, h, w, c, c)
    s_x, s_z = (SAT_S_IN["x"], SAT_S_IN["z"]) if sat else (0.1, 0.21)
    return x, kx, bias, z, kz, s_x, s_z


@pytest.mark.parametrize("p,c,h,w,sat", [(4, 32, 8, 16, False), (2, 64, 8, 16, False),
                                         (2, 64, 8, 16, True)],
                         ids=["4-32-8-16", "2-64-8-16", "saturating-2-64-8-16"])
def test_conv_prow_dual_planes_matches_pallas(rng, p, c, h, w, sat):
    """Kernel J at ub2.conv1's (32) and ub1.conv1's (64) channel counts, and
    with every input and weight at +-127; the JAX side takes the skip as the
    producer's two half-planes."""
    x, kx, bias, z, kz, s_x, s_z = _dual_case(rng, h, w, c, sat)
    z6 = z.reshape(2, h, w // (2 * p), 2, p * c)
    z_lo = jnp.asarray(z6[:, :, :, 0].reshape(2, h * w // (2 * p), p * c))
    z_hi = jnp.asarray(z6[:, :, :, 1].reshape(2, h * w // (2 * p), p * c))
    want = rows_to_nhwc(jax_px.conv_prow_dual_planes(
        nhwc_to_rows(jnp.asarray(x), p), z_lo, z_hi,
        jax_px.prow_leaf(kx, bias, p, s_in=s_x, s_out=0.05),
        jax_px.prow_leaf(kz, np.zeros_like(bias), p, s_in=s_z, s_out=0.05),
        p, c, c, h, w, interpret=True), h, w, c)
    wx, sx, bx = _leaf(kx, bias, s_x, 0.05)
    wz, sz, _ = _leaf(kz, np.zeros_like(bias), s_z, 0.05)
    got = conv_px.conv_prow_dual_planes(torch.from_numpy(x), torch.from_numpy(z), wx, wz,
                                        sx, sz, bx)
    _assert_identical(got.numpy(), want)


@pytest.mark.parametrize("h,n", [(16, 2), (32, 3)])
def test_conv_prow_up2_pack_matches_pallas(rng, h, n):
    """Kernel K (ub2.conv2 + the final x2), the pair-row output unpacked to
    NHWC."""
    p, c = 8, 32
    s_mid, s_up = 0.15, 0.25
    x, k, bias = _rand_case(rng, n, h, h, c, 16)
    leaf = jax_px.prow_leaf(k, bias, p, s_in=0.19, s_out=s_mid)
    _, rm, cc, inv = jax_px.up2_coeffs_mxu(h, h, 16, s_mid, s_up)
    leaf.update(rm=jnp.asarray(rm), cc=jnp.asarray(cc), inv=jnp.asarray(inv))
    want = jax_px.conv_prow_up2_pack(nhwc_to_rows(jnp.asarray(x), p // 2), leaf, p, c, h,
                                     fold=2, interpret=True)
    want = np.asarray(want).reshape(n, h, h, 2, 2, 16).transpose(0, 1, 3, 2, 4, 5)
    got = conv_px.conv_prow_up2_pack(torch.from_numpy(x), *_leaf(k, bias, 0.19, s_mid),
                                     *_up2_tables(h, h, s_mid, s_up))
    _assert_identical(got.numpy(), want.reshape(n, 2 * h, 2 * h, 16))


@pytest.mark.parametrize("s_in,s_out,post", [(0.11, 0.07, 1.0), (0.2, None, 1 / 0.15),
                                             (0.0132, 0.0571, 1.0)])
def test_prow_leaf_equals_jax(rng, s_in, s_out, post):
    """The port's scale folding, bit for bit: JAX tiles it across p slots."""
    k = rng.normal(size=(3, 3, 32, 32)).astype(np.float32) * 0.2
    bias = rng.normal(size=32).astype(np.float32)
    want = jax_px.prow_leaf(k, bias, 4, s_in, s_out, post)
    got = conv_px.prow_leaf(k, bias, s_in, s_out, post)
    assert got["scale"].dtype == got["bias"].dtype == np.float32
    np.testing.assert_array_equal(np.tile(got["scale"], 4), np.asarray(want["scale"]))
    np.testing.assert_array_equal(np.tile(got["bias"], 4), np.asarray(want["bias"]))
    wm, _ = jax_px.pack_prow_weights(got["w"], 4)
    np.testing.assert_array_equal(wm, np.asarray(want["wm"]))


@pytest.mark.parametrize("h,w,c_out", [(8, 16, 64), (32, 32, 64), (64, 64, 32), (128, 128, 16)])
def test_up2_coeffs_mxu_equal_jax(h, w, c_out):
    """The numerator tables and inv, bit for bit, against JAX's MXU layout:
    the (2h, h) row-mix matrix (row d*h + k makes output row 2k + d) and the
    per-lane column coefficients (each pixel's repeated over c_out)."""
    s_mid, s_up = 0.0731, 0.0913
    _, rm, cc, inv = jax_px.up2_coeffs_mxu(h, w, c_out, s_mid, s_up)
    rnum, cnum, got_inv = conv_px.up2_coeffs_mxu(h, w, s_mid, s_up)
    assert rnum.dtype == cnum.dtype == np.int32 and got_inv.dtype == np.float32
    assert got_inv == inv
    want_rm = np.zeros((2 * h, h), np.float32)
    for d in range(2):
        for t in range(3):
            for kk in range(h):
                if rnum[d, t, kk]:
                    want_rm[d * h + kk, kk + t - 1] = rnum[d, t, kk]
    np.testing.assert_array_equal(want_rm, rm)
    np.testing.assert_array_equal(np.repeat(cnum, c_out, axis=2).astype(np.float32), cc)


@pytest.mark.parametrize("p,c,h,w,sat", [(2, 64, 8, 16, False), (4, 32, 8, 16, False),
                                         (2, 64, 8, 16, True)],
                         ids=["2-64-8-16", "4-32-8-16", "saturating-2-64-8-16"])
def test_conv_prow_dual_matches_pallas(rng, p, c, h, w, sat):
    """Kernel L against the Pallas conv_prow_dual (the skip as one rows
    tensor, not half-planes): identical int8, and identical to kernel J."""
    x, kx, bias, z, kz, s_x, s_z = _dual_case(rng, h, w, c, sat)
    want = rows_to_nhwc(jax_px.conv_prow_dual(
        nhwc_to_rows(jnp.asarray(x), p), nhwc_to_rows(jnp.asarray(z), p),
        jax_px.prow_leaf(kx, bias, p, s_in=s_x, s_out=0.05),
        jax_px.prow_leaf(kz, np.zeros_like(bias), p, s_in=s_z, s_out=0.05),
        p, c, c, h, w, interpret=True), h, w, c)
    wx, sx, bx = _leaf(kx, bias, s_x, 0.05)
    wz, sz, _ = _leaf(kz, np.zeros_like(bias), s_z, 0.05)
    args = (torch.from_numpy(x), torch.from_numpy(z), wx, wz, sx, sz, bx)
    got = conv_px.conv_prow_dual(*args)
    _assert_identical(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), conv_px.conv_prow_dual_planes(*args).numpy())


def _up2_vpu_tables(h, w, s_mid, s_up):
    rc, cc, inv = conv_px.up2_coeffs(h, w, s_mid, s_up)
    return torch.from_numpy(rc), torch.from_numpy(cc), inv


@pytest.mark.parametrize("p,c,c_out,p_out,h,w,fold", [
    (2, 64, 64, 2, 8, 16, 1),      # db3.last-like
    (4, 64, 32, 4, 8, 16, 2),      # ub1.conv2-like (folded input rows)
])
def test_conv_prow_up2_vpu_matches_pallas(rng, p, c, c_out, p_out, h, w, fold):
    """Kernel I with the float32 tables (up2_impl='vpu'): identical int8 to
    the Pallas roll/fma kernel, and to the port's upsample_phases with
    in_scale on the conv's int8 output (the second oracle)."""
    from sifsr_tpu_torch.kernels import upsample_phases

    s_mid, s_up = 0.12, 0.2
    x, k, bias = _rand_case(rng, 2, h, w, c, c_out)
    leaf = jax_px.prow_leaf(k, bias, p, s_in=0.17, s_out=s_mid)
    _, rc, cc, inv = jax_px.up2_coeffs(h, w, c_out, s_mid, s_up)
    leaf.update(rc=jnp.asarray(rc), cc=jnp.asarray(cc), inv=jnp.asarray(inv))
    want = jax_px.conv_prow_up2(nhwc_to_rows(jnp.asarray(x), p // fold), leaf, p, c, c_out,
                                p_out, h, w, fold=fold, interpret=True)
    inv_perm = np.argsort(np.asarray(up2_perm(p_out)))
    want = np.asarray(want).reshape(2, 2 * h, (2 * w) // p_out, p_out, c_out)
    want = want[:, :, :, inv_perm, :].reshape(2, 2 * h, 2 * w, c_out)
    tleaf = _leaf(k, bias, 0.17, s_mid)
    got = conv_px.conv_prow_up2(torch.from_numpy(x), *tleaf, *_up2_vpu_tables(h, w, s_mid, s_up))
    _assert_identical(got.numpy(), want)
    mid = conv_px.conv_prow(torch.from_numpy(x), *tleaf)
    second = upsample_phases(mid, 2, "linear_ac", scale=s_up, in_scale=s_mid)
    np.testing.assert_array_equal(got.numpy(), second.numpy())


@pytest.mark.parametrize("h,n", [(16, 2), (32, 3)])
def test_conv_prow_up2_pack_vpu_matches_pallas(rng, h, n):
    """Kernel K with the float32 tables, the pair-row output unpacked."""
    p, c = 8, 32
    s_mid, s_up = 0.15, 0.25
    x, k, bias = _rand_case(rng, n, h, h, c, 16)
    leaf = jax_px.prow_leaf(k, bias, p, s_in=0.19, s_out=s_mid)
    _, rc, cc, inv = jax_px.up2_coeffs(h, h, 16, s_mid, s_up)
    leaf.update(rc=jnp.asarray(rc), cc=jnp.asarray(cc), inv=jnp.asarray(inv))
    want = jax_px.conv_prow_up2_pack(nhwc_to_rows(jnp.asarray(x), p // 2), leaf, p, c, h,
                                     fold=2, interpret=True)
    want = np.asarray(want).reshape(n, h, h, 2, 2, 16).transpose(0, 1, 3, 2, 4, 5)
    got = conv_px.conv_prow_up2_pack(torch.from_numpy(x), *_leaf(k, bias, 0.19, s_mid),
                                     *_up2_vpu_tables(h, h, s_mid, s_up))
    _assert_identical(got.numpy(), want.reshape(n, 2 * h, 2 * h, 16))


@pytest.mark.parametrize("h,w,c_out", [(8, 16, 64), (32, 32, 64), (64, 64, 32), (128, 128, 16)])
def test_up2_coeffs_equal_jax(h, w, c_out):
    """The float32 tables of up2_impl='vpu', bit for bit: JAX keeps rc as a
    (2, nd, h, 1) column and repeats cc over the c_out lanes of a pixel."""
    s_mid, s_up = 0.0731, 0.0913
    deltas, rc, cc, inv = jax_px.up2_coeffs(h, w, c_out, s_mid, s_up)
    got_rc, got_cc, got_inv = conv_px.up2_coeffs(h, w, s_mid, s_up)
    assert deltas == (-1, 0, 1)
    assert got_rc.dtype == got_cc.dtype == np.float32 and got_inv.dtype == np.float32
    assert got_inv == inv
    np.testing.assert_array_equal(got_rc, rc[..., 0])
    np.testing.assert_array_equal(np.repeat(got_cc, c_out, axis=2), cc)
