"""The port's evaluation metrics and spectra (``sifsr_tpu_torch.eval.metrics``,
``eval.spectra``) against the JAX package's on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.eval import metrics as jm
from sifsr_tpu.eval import spectra as js

from sifsr_tpu_torch.eval import metrics as tm
from sifsr_tpu_torch.eval import spectra as ts


def _pair(rng, n=3, h=40, w=36):
    """Kelvin-scale images with structure and noise (SSIM/GSSIM not degenerate)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 300.0 + 8.0 * np.sin(yy / 7.0) + 6.0 * np.cos(xx / 9.0)
    target = base + rng.normal(0, 0.8, (n, h, w))
    pred = base + rng.normal(0, 0.8, (n, h, w)) + 0.4 * rng.random((n, h, w))
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("fn", ["gssim", "rmse", "gradient_rmse"])
def test_batch_metrics_match_jax(rng, fn):
    """gssim (with the batch's data range), rmse and gradient_rmse per image
    within 1e-5 relative of JAX (float32, convolutions at full precision on
    both sides)."""
    pred, target = _pair(rng)
    if fn == "gssim":
        dr = float(target.max() - target.min())
        got = tm.gssim(torch.from_numpy(pred), torch.from_numpy(target), torch.tensor(dr))
        want = jm.gssim(jnp.asarray(pred), jnp.asarray(target), jnp.float32(dr))
    else:
        got = getattr(tm, fn)(torch.from_numpy(pred), torch.from_numpy(target))
        want = getattr(jm, fn)(jnp.asarray(pred), jnp.asarray(target))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_stratified_rmse_matches_jax(rng):
    """The three strata RMSEs of a per-pixel field's quartiles (jnp.quantile's
    linear rule, float32 index) within 1e-5 of JAX."""
    pred, target = _pair(rng)
    field = np.abs(rng.normal(size=target.shape)).astype(np.float32)
    got = tm.stratified_rmse(*(torch.from_numpy(a) for a in (pred, target, field)))
    want = jm.stratified_rmse(*(jnp.asarray(a) for a in (pred, target, field)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["ssim_np", "psnr_np", "gssim_np"])
def test_numpy_forms_equal_jax(rng, fn):
    """The harness's float64 numpy forms are the JAX package's, value for value."""
    pred, target = _pair(rng, n=1, h=57, w=43)
    p, t = pred[0].astype(np.float64), target[0].astype(np.float64)
    dr = float(max(p.max(), t.max()) - min(p.min(), t.min()))
    assert getattr(tm, fn)(p, t, dr) == getattr(jm, fn)(p, t, dr)


@pytest.mark.parametrize("shape", [(64, 64), (57, 80), (3, 48, 40), (150, 160)])
def test_attenuation_spectrum_matches_jax(rng, shape):
    """Single and batched spectra of 300 K images against JAX's and the
    float64 numpy form. The port transforms in float64: within 1e-5 dB of
    ``attenuation_spectrum_np`` (float32 output rounding at ~40 dB). JAX's
    float32 transform itself is off float64 by up to 1.2e-4 dB in the
    rings at these sizes, so the bound against JAX is 2e-4 dB. Entry 0 is
    the f0/f0 quirk, 1.0, on all three."""
    img = (300.0 + rng.normal(0, 2.0, shape)).astype(np.float32)
    got = ts.attenuation_spectrum(torch.from_numpy(img)).numpy()
    want = np.asarray(js.attenuation_spectrum(jnp.asarray(img)))
    exact = np.stack([ts.attenuation_spectrum_np(im) for im in
                      img.astype(np.float64).reshape(-1, *shape[-2:])]).reshape(got.shape)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(got[..., 0] == 1.0) and np.all(want[..., 0] == 1.0)
    assert np.abs(got - exact).max() <= 1e-5
    assert np.abs(got - want).max() <= 2e-4


def test_restitution_scores_match_jax(rng):
    """pfr, afr, frr, fro and fru on seeded spectra within 1e-5 relative."""
    pb, rb, xb = (rng.normal(-10, 3, (2, 30)).astype(np.float32) for _ in range(3))
    for name in ("afr", "frr", "fro", "fru"):
        got = getattr(ts, name)(*(torch.from_numpy(a) for a in (pb, rb, xb)))
        want = getattr(js, name)(*(jnp.asarray(a) for a in (pb, rb, xb)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = ts.pfr(torch.from_numpy(rb), torch.from_numpy(xb))
    np.testing.assert_allclose(got.numpy(), np.asarray(js.pfr(jnp.asarray(rb), jnp.asarray(xb))),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (57, 80)])
def test_attenuation_spectrum_np_equals_jax(rng, shape):
    img = 300.0 + rng.normal(0, 2.0, shape)
    np.testing.assert_array_equal(ts.attenuation_spectrum_np(img), js.attenuation_spectrum_np(img))
