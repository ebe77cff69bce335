"""Kernels M (fused_psf_downscale, with its backward) and N (fused_norm_l4) of
the port: the plain PyTorch versions, which the wrappers run on CPU tensors,
against the JAX package's Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sifsr_tpu.losses.losses import huber as jax_huber
from sifsr_tpu.ops.psf import downscale_matrix as jax_downscale_matrix

from sifsr_tpu_torch.kernels import fused_ops
from sifsr_tpu_torch.losses.losses import huber

MEAN, STD = 295.0, 10.0


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr("sifsr_tpu.pallas.fused_ops.pl.pallas_call", interp_call)


@pytest.mark.parametrize("shape", [(3, 256, 256), (2, 64, 64)])
def test_fused_psf_downscale_matches_pallas(rng, shape):
    """1e-5: float32 sums of `size` terms in another order (the JAX package's
    own test of its kernel allows 1e-4)."""
    from sifsr_tpu.pallas.fused_ops import fused_psf_downscale as jax_fused

    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax_fused(jnp.asarray(x), MEAN, STD))
    got = fused_ops.fused_psf_downscale(torch.from_numpy(x), MEAN, STD)
    assert got.shape == want.shape == (shape[0], shape[1] // 4, shape[2] // 4)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(got, fused_ops.fused_psf_downscale_plain(torch.from_numpy(x), MEAN, STD))


def test_fused_psf_downscale_value_and_grad_match_pallas(rng):
    """huber(fused_psf_downscale(x), t): value 1e-5, gradient rtol 1e-4 /
    atol 1e-6 against jax.value_and_grad through the kernel's custom VJP."""
    from sifsr_tpu.pallas.fused_ops import fused_psf_downscale as jax_fused

    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    t = rng.normal(size=(2, 16, 16)).astype(np.float32)
    v_j, g_j = jax.value_and_grad(
        lambda a: jax_huber(jax_fused(a, MEAN, STD), jnp.asarray(t)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    v_t = huber(fused_ops.fused_psf_downscale(xt, MEAN, STD), torch.from_numpy(t))
    v_t.backward()
    assert abs(float(v_t.detach()) - float(v_j)) < 1e-5
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("size", [64, 256])
def test_sandwich_constants_equal_jax_bitwise(size):
    """The kernel's M, Mᵀ and constant surface are the JAX kernel's operands
    bit for bit (float64 matrix, the constant formed in float64, then cast)."""
    m64 = jax_downscale_matrix(size, 4, 0.1, None, "bic", True)
    row = m64.sum(axis=1)
    want_const = (MEAN * (np.outer(row, row) - 1.0) / STD).astype(np.float32)
    want_m = np.asarray(jnp.asarray(m64, jnp.float32))
    m, mt, const = fused_ops._sandwich_constants(size, 4, 0.1, MEAN, STD, torch.device("cpu"))
    assert m.dtype == mt.dtype == const.dtype == torch.float32
    assert mt.is_contiguous()
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_array_equal(mt.numpy(), want_m.T)
    np.testing.assert_array_equal(const.numpy(), want_const)


@pytest.mark.parametrize("renorm", [False, True])
def test_fused_norm_l4_matches_pallas(rng, renorm):
    """rtol 1e-5 as the JAX package's own test; with renorm the final
    (y - mean)/std cancels the leading digits, so the bound is taken on the
    un-normalised value there."""
    from sifsr_tpu.pallas.fused_ops import fused_norm_l4 as jax_norm_l4

    x = rng.normal(size=(2, 64, 64)).astype(np.float32)
    want = np.asarray(jax_norm_l4(jnp.asarray(x), MEAN, STD, renorm=renorm))
    got = fused_ops.fused_norm_l4(torch.from_numpy(x), MEAN, STD, renorm=renorm).numpy()
    assert got.shape == want.shape == (2, 16, 16)
    if renorm:
        got, want = got * STD + MEAN, want * STD + MEAN
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fused_norm_l4_defaults_and_shapes(rng):
    """mean 0 / std 1 / factor 2 on a non-square batch is the plain norm-L4
    pool; a size that is no multiple of the factor raises."""
    from sifsr_tpu.ops.pooling import norm_l4_downsample as jax_pool

    x = rng.normal(size=(3, 40, 36)).astype(np.float32)
    got = fused_ops.fused_norm_l4(torch.from_numpy(x), factor=2).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_pool(jnp.asarray(x), 2)), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        fused_ops.fused_norm_l4(torch.from_numpy(x), factor=16)


def test_autograd_function_backward_is_the_transposed_sandwich(rng):
    """The gradient that _FusedPsfDownscale.backward computes on the card,
    Mᵀ g M, written with the cached Mᵀ and M, equals autograd's gradient of
    the plain chain; and the plain chain passes gradcheck in float64."""
    x = torch.from_numpy(rng.normal(size=(1, 16, 16))).requires_grad_()   # float64
    assert torch.autograd.gradcheck(
        lambda a: fused_ops.fused_psf_downscale_plain(a, MEAN, STD), (x,), atol=1e-6)
    g = torch.from_numpy(rng.normal(size=(1, 4, 4)))
    (want,) = torch.autograd.grad(fused_ops.fused_psf_downscale_plain(x, MEAN, STD), x, g)
    m, mt, _ = fused_ops._sandwich_constants(16, 4, 0.1, MEAN, STD, torch.device("cpu"))
    got = torch.matmul(torch.matmul(mt.double(), g), m.double())
    # M is the float32 cast of the float64 matrix: 1e-7 relative
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float32"):
        fused_ops.fused_psf_downscale(torch.zeros(1, 8, 8, dtype=torch.float64), MEAN, STD)
    with pytest.raises(ValueError, match=r"\(N, H, H\)"):
        fused_ops.fused_psf_downscale(torch.zeros(1, 8, 12), MEAN, STD)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ops.fused_psf_downscale(torch.zeros(1, 8, 8, device="meta"), MEAN, STD)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ops.fused_norm_l4(torch.zeros(1, 8, 8, device="meta"))


def test_launch_counters_registered():
    """M and N are in KERNELS; reset_launches also zeroes M's backward count;
    the plain route on CPU tensors counts nothing."""
    from sifsr_tpu_torch import kernels as K

    assert fused_ops.fused_psf_downscale in K.KERNELS and fused_ops.fused_norm_l4 in K.KERNELS
    K.fused_psf_downscale.launches = K.fused_psf_downscale.backward_launches = 7
    K.fused_norm_l4.launches = 3
    K.reset_launches()
    x = torch.zeros(1, 16, 16, requires_grad=True)
    K.fused_psf_downscale(x, MEAN, STD).sum().backward()
    K.fused_norm_l4(x.detach())
    assert (K.fused_psf_downscale.launches, K.fused_psf_downscale.backward_launches,
            K.fused_norm_l4.launches) == (0, 0, 0)


def _unband(lo, coef, cols):
    a = np.zeros((len(lo), cols), np.float32)
    for r, (l, c) in enumerate(zip(lo, coef)):
        a[r, l:l + len(c)] = c
    return a


@pytest.mark.parametrize("size", [64, 128, 256])
@pytest.mark.parametrize("mtf", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_band_rebuilds_m_and_mt_bitwise(factor, mtf, size):
    """Kernel M's bands of M (2·factor + 4 coefficients a row) and of Mᵀ (at
    most 4) give back the float32 matrices of _sandwich_constants, and
    JAX's, bit for bit; every row's band lies inside the matrix."""
    want_m = np.asarray(jnp.asarray(jax_downscale_matrix(size, factor, mtf, None, "bic", True),
                                    jnp.float32))
    m, mt, _ = fused_ops._sandwich_constants(size, factor, mtf, MEAN, STD, torch.device("cpu"))
    np.testing.assert_array_equal(m.numpy(), want_m)
    widths = []
    for a in (m.numpy(), mt.numpy()):
        lo, coef = fused_ops._band(a)
        assert lo.dtype == np.int32 and coef.dtype == np.float32
        assert lo.shape == (a.shape[0],) and coef.shape[0] == a.shape[0]
        assert lo.min() >= 0 and lo.max() + coef.shape[1] <= a.shape[1]
        np.testing.assert_array_equal(_unband(lo, coef, a.shape[1]), a)
        widths.append(coef.shape[1])
    assert widths[0] == 2 * factor + 4 and widths[1] <= 4
    bands = fused_ops._sandwich_bands(size, factor, mtf, torch.device("cpu"))
    for band, a in zip(bands, (m, mt)):
        np.testing.assert_array_equal(_unband(band.lo.numpy(), band.coef.numpy(), a.shape[1]),
                                      a.numpy())


@pytest.mark.parametrize("size", [64, 128, 256])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_band_tiles_cover_every_block(factor, size):
    """A launch gives tile t the input rows [min lo, max lo + width) of its
    output rows (8 a block forward, 32 backward), and a span that holds the
    most of them, for M and Mᵀ."""
    bands = fused_ops._sandwich_bands(size, factor, 0.1, torch.device("cpu"))
    for band, rows, cols in zip(bands, (8, 32), (size, size // factor)):
        lo, width = band.lo.numpy(), band.coef.shape[1]
        want = [(lo[r:r + rows].min(), lo[r:r + rows].max() + width)
                for r in range(0, len(lo), rows)]
        assert band.tile_in.dtype == np.int32 and band.tile_in.flags.c_contiguous
        np.testing.assert_array_equal(band.tile_in, np.array(want))
        assert band.rows == rows
        assert band.span == max(k1 - k0 for k0, k1 in want) <= cols


# (size, factor): (forward rows, chunk; backward rows, chunk) of _tiling
_TILINGS = {(256, 8): (8, 256, 32, 32), (1024, 4): (8, 1024, 32, 256),
            (1024, 8): (8, 512, 32, 128), (2048, 2): (8, 1024, 32, 1024),
            (256, 16): (8, 256, 32, 16), (2048, 16): (8, 256, 32, 128),
            (4096, 2): (8, 1024, 16, 1024)}


@pytest.mark.parametrize("size,factor", list(_TILINGS))
def test_band_tiles_fit_shared_memory(size, factor):
    """Every tiling the host chooses stages within the 227 KB of shared
    memory a block, both ways, and the wrapper takes it: at the recipes'
    sizes in one chunk of columns and 8 / 32 output rows a block; 1024² at
    factor 8 (76 staged rows of 4 KB) and 2048² at factor 2 (22 of 8 KB) in
    two chunks; 4096² at factor 2 also with 16 rows a block backward (T's 32
    rows of 2,048 floats would not fit), in 256 tiles, which the entry
    launches in two turns of 128."""
    bands = fused_ops._sandwich_bands(size, factor, 0.1, torch.device("cpu"))
    got = []
    for band, cols in zip(bands, (size, size // factor)):
        width = band.coef.shape[1]
        fused_ops._check_band(cols, band)
        assert fused_ops._stage_bytes(band.rows, width, cols, band.span,
                                      band.chunk) <= 227 * 1024
        assert band.chunk % 4 == 0 and band.chunk >= 4
        chunks = -(-cols // band.chunk)
        # the fewest chunks: one fewer would not fit; one chunk takes every column
        assert chunks == 1 or fused_ops._stage_bytes(
            band.rows, width, cols, band.span, -(-cols // (chunks - 1))) > 227 * 1024
        assert len(band.tile_in) == -(-len(band.lo) // band.rows)
        got += [band.rows, band.chunk]
    assert tuple(got) == _TILINGS[size, factor]
    assert fused_ops._shape_refusal(size, factor, 0.1) is None


def test_band_refuses_a_stage_past_shared_memory():
    """A band whose block would not fit even at one output row and chunks of
    4 columns (T's one row of 60,000 floats alone is 242 KB) is refused
    before any launch."""
    lo = np.zeros(4, np.int32)
    rows, chunk, tile_in, span = fused_ops._tiling(lo, 3, 60_000, 8)
    assert (rows, chunk, span) == (1, 4, 3)
    band = fused_ops._Band(torch.as_tensor(lo), torch.ones(4, 3), tile_in, rows, span, chunk)
    with pytest.raises(ValueError, match="shared memory"):
        fused_ops._check_band(60_000, band)


def test_sandwich_passes_the_band_to_the_entry(monkeypatch):
    """The host side of kernel M's launch, with the library and the CUDA
    stream stood in for: the entry gets the band's pointers, its tile table
    and (n, in, out, width, rows, span, chunk) as csrc/fused_ops.cu declares
    them, forward with the constant and backward without."""
    import contextlib

    calls = []

    class Lib:
        def sifsr_sandwich(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fused_ops, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 7})())
    cpu = torch.device("cpu")
    band_m, band_mt = fused_ops._sandwich_bands(256, 4, 0.1, cpu)
    const = fused_ops._renorm_constant(256, 4, 0.1, MEAN, STD, cpu)
    x, g = torch.zeros(3, 256, 256), torch.zeros(3, 64, 64)
    y = fused_ops._sandwich(x, band_m, const)
    dx = fused_ops._sandwich(g, band_mt, None)
    assert y.shape == (3, 64, 64) and dx.shape == (3, 256, 256)
    (fwd, bwd) = calls
    assert fwd[:3] == (x.data_ptr(), band_m.lo.data_ptr(), band_m.coef.data_ptr())
    assert fwd[3] == band_m.tile_in.ctypes.data and fwd[4] == const.data_ptr()
    assert fwd[6:] == (3, 256, 64, 12, 8, band_m.span, 256, 7)
    assert bwd[4] is None and bwd[6:] == (3, 64, 256, 3, 32, band_mt.span, 64, 7)
    assert len(fwd) == len(bwd) == 14   # the entry's ctypes signature


def test_band_refuses_what_the_kernel_does_not_take():
    """A row whose nonzeros are not one run has no band; a band wider than
    the kernel's 64 coefficients (factor 32: 68) is refused before any
    launch."""
    a = np.zeros((3, 8), np.float32)
    a[0, 1:4] = 1.0
    a[1, [2, 5]] = 1.0
    with pytest.raises(ValueError, match="contiguous"):
        fused_ops._band(a)
    wide, _ = fused_ops._sandwich_bands(256, 32, 0.1, torch.device("cpu"))
    assert wide.coef.shape[1] == 68
    with pytest.raises(ValueError, match="at most 64"):
        fused_ops._sandwich(torch.zeros(1, 256, 256), wide, None)


def _banded_sandwich64(x, lo, coef, const=None):
    """A @ x[i] @ Aᵀ (+ const) in float64 from A's band, as the kernel sums:
    T = A·X with each sum ascending over the row's band, then T·Aᵀ the
    same way."""
    x, coef = x.double(), coef.double()
    cols = lo[:, None].long() + torch.arange(coef.shape[1])
    t = torch.zeros(x.shape[0], coef.shape[0], x.shape[2], dtype=torch.float64)
    for w in range(coef.shape[1]):
        t = t + coef[:, w, None] * x[:, cols[:, w], :]
    y = torch.zeros(x.shape[0], coef.shape[0], coef.shape[0], dtype=torch.float64)
    for w in range(coef.shape[1]):
        y = y + t[:, :, cols[:, w]] * coef[:, w]
    return y if const is None else y + const.double()


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_banded_sandwich_matches_pallas(rng, factor, size):
    """The band's arithmetic against the JAX package's kernel (interpret
    mode), within 1e-5: the forward with M's band and the constant, and
    _psf_downscale_bwd with Mᵀ's band."""
    from sifsr_tpu.pallas.fused_ops import _psf_downscale_bwd
    from sifsr_tpu.pallas.fused_ops import fused_psf_downscale as jax_fused

    x = rng.normal(size=(2, size, size)).astype(np.float32)
    g = rng.normal(size=(2, size // factor, size // factor)).astype(np.float32)
    cpu = torch.device("cpu")
    band_m, band_mt = fused_ops._sandwich_bands(size, factor, 0.1, cpu)
    const = fused_ops._sandwich_constants(size, factor, 0.1, MEAN, STD, cpu)[2]
    got = _banded_sandwich64(torch.from_numpy(x), band_m.lo, band_m.coef, const)
    want = np.asarray(jax_fused(jnp.asarray(x), MEAN, STD, factor=factor, mtf=0.1))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5
    (want_dx,) = _psf_downscale_bwd(size, MEAN, STD, factor, 0.1, None, jnp.asarray(g))
    got_dx = _banded_sandwich64(torch.from_numpy(g), band_mt.lo, band_mt.coef)
    assert got_dx.shape == (2, size, size)
    assert np.abs(got_dx.numpy() - np.asarray(want_dx)).max() <= 1e-5


@pytest.mark.parametrize("size,factor,mtf,takes", [
    (256, 4, 0.1, True), (256, 4, 0.25, True), (1024, 4, 0.1, True),
    (256, 16, 0.1, True), (1024, 8, 0.1, True), (2048, 2, 0.1, True), (256, 32, 0.1, False)])
def test_kernel_takes(size, factor, mtf, takes):
    """The host's decision before kernel M's launch: the kernel takes the
    recipes' shapes (256² at factor 4, mtf 0.1 and 0.25), 1024² at factor 4,
    and factor 16 at 256² (a band of 36), 1024² at factor 8 and 2048² at
    factor 2 (staged in chunks of columns); not factor 32 (a band of 68),
    exactly where _check_band raises on M's or Mᵀ's band."""
    assert (fused_ops._shape_refusal(size, factor, mtf) is None) is takes
    band_m, band_mt = fused_ops._sandwich_bands(size, factor, mtf, torch.device("cpu"))
    refused = [fused_ops._band_refusal(size, band_m),
               fused_ops._band_refusal(size // factor, band_mt)]
    assert (refused == [None, None]) is takes


def test_card_route_skips_the_kernel_where_it_refuses(monkeypatch):
    """The CUDA route with the library stood in for: a shape the kernel does
    not take (factor 32 at 256²) raises ValueError and never reaches
    sifsr_sandwich; factor 16 and factor 4 at 256² reach it, forward and
    backward, one launch each way."""
    import contextlib

    calls = []

    class Lib:
        def sifsr_sandwich(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fused_ops, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 7})())
    f = fused_ops.fused_psf_downscale
    monkeypatch.setattr(f, "launches", 0)
    monkeypatch.setattr(f, "backward_launches", 0)
    x = torch.zeros(2, 256, 256, requires_grad=True)
    with pytest.raises(ValueError, match="a band of 68"):
        fused_ops._on_card(x, MEAN, STD, 32, 0.1)
    assert (calls, f.launches, f.backward_launches) == ([], 0, 0)
    for factor, n_calls in ((16, 2), (4, 4)):
        fused_ops._on_card(x, MEAN, STD, factor, 0.1).sum().backward()
        assert (len(calls), f.launches, f.backward_launches) == (n_calls, n_calls // 2,
                                                                 n_calls // 2)
    assert [c[9] for c in calls] == [36, 3, 12, 3]   # band widths: M's, Mᵀ's


def test_band_at_factor_16_matches_the_jax_chain(rng):
    """Factor 16 at 256², the band of 36 the kernel now takes: the band's
    float64 arithmetic (the forward with M's band and the constant, the
    gradient as Mᵀ's band applied to huber's gradient) equals JAX's off-TPU
    ds_loss matmul chain (use_pallas=False) on the same seeded arrays within
    1e-5: the degraded batch, the loss and its gradient."""
    from sifsr_tpu.losses.losses import ds_loss as jax_ds_loss
    from sifsr_tpu.ops.psf import downscale_lst_sr_to_lr as jax_downscale

    x = rng.normal(size=(2, 256, 256)).astype(np.float32)
    t = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    want_y = (np.asarray(jax_downscale(jnp.asarray(x * STD + MEAN)[:, None], factor=16,
                                       mtf=0.1))[:, 0] - MEAN) / STD
    v_j, g_j = jax.value_and_grad(
        lambda a: jax_ds_loss(a, jnp.asarray(t), MEAN, STD, factor=16, mtf=0.1,
                              use_pallas=False))(jnp.asarray(x[..., None]))
    cpu = torch.device("cpu")
    band_m, band_mt = fused_ops._sandwich_bands(256, 16, 0.1, cpu)
    const = fused_ops._renorm_constant(256, 16, 0.1, MEAN, STD, cpu)
    y = _banded_sandwich64(torch.from_numpy(x), band_m.lo, band_m.coef,
                           const).requires_grad_()
    assert y.shape == (2, 16, 16)
    assert np.abs(y.detach().numpy() - want_y).max() <= 1e-5
    v_t = huber(y[..., None], torch.from_numpy(t).double())
    v_t.backward()
    dx = _banded_sandwich64(y.grad, band_mt.lo, band_mt.coef)
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-5
    assert np.abs(dx.numpy() - np.asarray(g_j)[..., 0]).max() <= 1e-5
