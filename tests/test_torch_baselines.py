"""The port's TsHARP, ATPRK and AATPRK (``sifsr_tpu_torch.baselines``)
against the JAX package's on the same seeded numpy inputs, and the four
classical baselines through the port's ``cli.model_perf.make_sr_fn``.

The three methods are the JAX package's numpy and scipy: on identical
inputs the outputs are identical. Through ``make_sr_fn`` the coarse NDVI is
pooled by torch here and by ``jnp`` there, so the outputs agree within
1e-3 K."""

import numpy as np
import pytest

from sifsr_tpu.baselines import aatprk as jax_aatprk
from sifsr_tpu.baselines import atprk as jax_atprk
from sifsr_tpu.baselines import tsharp as jax_tsharp
from sifsr_tpu.baselines.aatprk import windowed_fit as jax_windowed_fit
from sifsr_tpu.baselines.atprk import empirical_variogram as jax_empirical_variogram
from sifsr_tpu.cli import model_perf as jmp

from sifsr_tpu_torch.baselines import aatprk, atprk, tsharp
from sifsr_tpu_torch.baselines.aatprk import windowed_fit
from sifsr_tpu_torch.baselines.atprk import empirical_variogram
from sifsr_tpu_torch.cli import model_perf


def _pair(rng, n=32, factor=4):
    """Anticorrelated LST/NDVI with smooth structure and noise (the pair of
    tests/test_baselines.py at a smaller size), a 0 K hole and a NaN NDVI
    pixel to exercise the validity masks."""
    f = n * factor
    yy, xx = np.meshgrid(np.linspace(0, 4, f), np.linspace(0, 4, f), indexing="ij")
    ndvi_fine = 0.45 + 0.3 * np.sin(yy * 1.7) * np.cos(xx * 1.3) + 0.05 * rng.normal(size=(f, f))
    ndvi_fine = np.clip(ndvi_fine, -1, 1)
    lst_fine = 300.0 - 12.0 * ndvi_fine + 0.3 * rng.normal(size=(f, f))
    lst_coarse = lst_fine.reshape(n, factor, n, factor).mean(axis=(1, 3))
    ndvi_coarse = ndvi_fine.reshape(n, factor, n, factor).mean(axis=(1, 3))
    lst_coarse[3, 4] = 0.0
    ndvi_coarse[7, 9] = np.nan
    return lst_coarse, ndvi_coarse, ndvi_fine


@pytest.mark.parametrize("min_t", [273.0, 285.0])
def test_tsharp_identical_to_jax(rng, min_t):
    lst, nd_c, nd_f = _pair(rng)
    np.testing.assert_array_equal(tsharp(lst, nd_c, nd_f, 4, min_t=min_t),
                                  jax_tsharp(lst, nd_c, nd_f, 4, min_t=min_t))


@pytest.mark.parametrize("name", ["ATPRK", "AATPRK"])
@pytest.mark.parametrize("block_size", [3, 5])
def test_atprk_family_identical_to_jax(rng, name, block_size):
    lst, nd_c, nd_f = _pair(rng)
    lst[3, 4] = 299.0  # the kriging sees no hole
    nd_c[7, 9] = 0.4
    port, ref = (atprk, jax_atprk) if name == "ATPRK" else (aatprk, jax_aatprk)
    kw = dict(scale=4, scc=926, block_size=block_size, min_t=273)
    np.testing.assert_array_equal(port(lst, nd_c, nd_f, **kw), ref(lst, nd_c, nd_f, **kw))


def test_variogram_and_windowed_fit_identical_to_jax(rng):
    lst, nd_c, _ = _pair(rng)
    for got, want in zip(empirical_variogram(lst - 300.0, 5, 926.0),
                         jax_empirical_variogram(lst - 300.0, 5, 926.0)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(windowed_fit(nd_c, lst, 273.0, 2), jax_windowed_fit(nd_c, lst, 273.0, 2)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coarse_ndvi_equals_jax_pooling(rng, dtype):
    """make_sr_fn's coarse NDVI for TsHARP, ATPRK and AATPRK: the bits of
    the JAX package's norm_l4_downsample (jnp, float32) clipped to [-1, 1],
    over signed values and values past 1."""
    import jax.numpy as jnp

    from sifsr_tpu.ops.pooling import norm_l4_downsample as jax_pool

    ndvi = rng.uniform(-1.3, 1.3, (256, 256)).astype(dtype)
    want = np.clip(np.asarray(jax_pool(jnp.asarray(ndvi)[None], 4))[0], -1, 1)
    got = model_perf._coarse_ndvi(ndvi)
    assert got.dtype == np.float32 and got.shape == (64, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr_type", ["TsHARP", "ATPRK", "AATPRK"])
def test_make_sr_fn_baselines_match_jax(rng, sr_type):
    """On a 64² / 256² pair in the harness's float32: within 1e-3 K of JAX's
    sr_fn (the coarse NDVI: torch's norm-L4 pooling against jnp's)."""
    lst, _, ndvi = _pair(rng, n=64)
    lst[3, 4] = 299.0
    lst, ndvi = lst.astype(np.float32), ndvi.astype(np.float32)
    got = model_perf.make_sr_fn(sr_type, "", "", device="cpu")(lst, ndvi)
    want = np.asarray(jmp.make_sr_fn(sr_type, "", "")(lst, ndvi))
    assert got.shape == want.shape == (256, 256)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3


def test_make_sr_fn_dms_matches_jax(rng):
    """DMS through make_sr_fn (both packages' default options, random_state
    0) within 1e-4 K of JAX's at 16² coarse."""
    lst, _, ndvi = _pair(rng, n=16)
    lst[3, 4] = 299.0
    lst, ndvi = lst.astype(np.float32), ndvi.astype(np.float32)
    got = model_perf.make_sr_fn("DMS", "", "", device="cpu")(lst, ndvi)
    want = jmp.make_sr_fn("DMS", "", "")(lst, ndvi)
    assert got.shape == want.shape == (64, 64)
    assert np.abs(got - want).max() <= 1e-4
