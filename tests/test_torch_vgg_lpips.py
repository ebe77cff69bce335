"""The port's VGG16 trunk and LPIPS (``sifsr_tpu_torch.models.vgg``,
``eval.lpips``) against the JAX package's on the same torchvision-layout
weights, made from a seed with numpy."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sifsr_tpu.eval.lpips import LPIPS as JaxLPIPS
from sifsr_tpu.models.vgg import VGG16Features as JaxVGG16Features
from sifsr_tpu.models.vgg import convert_torchvision_vgg16 as jax_convert

from sifsr_tpu_torch.eval.lpips import LPIPS
from sifsr_tpu_torch.models.convert import from_jax_vgg16, to_jax_vgg16
from sifsr_tpu_torch.models.vgg import LPIPS_LAYERS, VGG16Features, convert_torchvision_vgg16

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Seeded full-width VGG16 weights (torchvision's ``features.N.*``
    layout, 14.7 M parameters) and LPIPS layer weights, as chip_smoke.py's
    eval phase writes them."""
    sys.path.insert(0, ROOT)
    from chip_smoke import write_lpips_weights

    return write_lpips_weights(str(tmp_path_factory.mktemp("lpips_weights")))


def _vgg_state_dict(weight_files):
    return torch.load(weight_files[0], weights_only=True)


def test_vgg_taps_match_jax_on_an_odd_size(weight_files):
    """The five taps on a 37x45 input (each max pool floors an odd size:
    37 -> 18 -> 9 -> 4 -> 2) equal JAX's ``VGG16Features`` within 1e-5 of
    each tap's largest value."""
    sd = _vgg_state_dict(weight_files)
    model = VGG16Features()
    model.load_state_dict(convert_torchvision_vgg16(sd))
    x = np.random.default_rng(3).random((1, 37, 45, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = JaxVGG16Features().apply(jax_convert({k: v.numpy() for k, v in sd.items()}),
                                    jnp.asarray(x))
    assert list(got) == list(LPIPS_LAYERS)
    for layer in LPIPS_LAYERS:
        g = got[layer].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[layer])
        assert g.shape == w.shape, layer
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), layer
    assert got["relu5_3"].shape[-2:] == (2, 2)


def test_convert_takes_both_key_layouts(weight_files):
    """``features.N.*`` (a whole torchvision VGG16, classifier keys left out)
    and ``N.*`` (its ``features``) give the same state dict, which is the
    JAX converter's tree through the weight carrier, both ways."""
    full = dict(_vgg_state_dict(weight_files))
    features = {k[len("features."):]: v for k, v in full.items()}
    full["classifier.0.weight"] = torch.zeros(4, 4)
    a = convert_torchvision_vgg16(full)
    b = convert_torchvision_vgg16(features)
    assert list(a) == list(b) == list(VGG16Features().state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    jax_tree = jax_convert({k: v.numpy() for k, v in features.items()})
    c = from_jax_vgg16(jax_tree)
    assert all(torch.equal(a[k], c[k]) for k in a)
    back = to_jax_vgg16(c)
    for name, leaf in jax_tree["params"].items():
        np.testing.assert_array_equal(back["params"][name]["kernel"], leaf["kernel"])
        np.testing.assert_array_equal(back["params"][name]["bias"], leaf["bias"])


def test_lpips_matches_jax(weight_files):
    """LPIPS of two seeded 48x52 images in [0, 1] from the same .pt files
    within 1e-5 relative of JAX's; identical inputs give 0."""
    rng = np.random.default_rng(5)
    a = rng.random((48, 52)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    port = LPIPS(*weight_files, device="cpu")
    ref = JaxLPIPS(*weight_files)
    assert port.available and ref.available
    got, want = port(a, b), ref(a, b)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= 1e-5 * abs(want)
    assert port(a, a) == pytest.approx(0.0, abs=1e-9)


def test_lpips_is_nan_without_weights(tmp_path):
    """Without the two weight files LPIPS is unavailable and NaN, as in JAX."""
    missing = str(tmp_path / "none.pt")
    port = LPIPS(missing, missing, device="cpu")
    assert not port.available and not JaxLPIPS(missing, missing).available
    assert np.isnan(port(np.zeros((8, 8)), np.zeros((8, 8))))
