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
