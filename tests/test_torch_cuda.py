"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (counting no pass) where there is no card.
The file stands alone (no JAX, no conftest fixtures), so on a machine with
an H100 and no JAX it runs as
``python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider``.
chip_smoke.py repeats these checks at serving shapes.
"""

import numpy as np
import pytest
import torch

from sifsr_tpu_torch.kernels import conv_i8, resize_phases

pytestmark = pytest.mark.cuda


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built by nvcc for sm_90a)")
    return torch.device("cuda")


def _i8(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("factor,kind,size,c", [(4, "cubic", 64, 1), (2, "linear_ac", 32, 16)])
@pytest.mark.parametrize("scale", [None, 0.02])
def test_upsample_phases_cuda(rng, cuda, factor, kind, size, c, scale):
    x = _f32(3.0 * rng.standard_normal((3, size, size, c)))
    want = resize_phases.upsample_phases_plain(x.to(cuda), factor, kind, scale)
    got = resize_phases.upsample_phases(x.to(cuda), factor, kind, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(64, 64), (40, 36)])
@pytest.mark.parametrize("pm", [None, 0.17])
def test_conv_i8_exact_cuda(rng, cuda, h, w, pm):
    args = [_i8(rng, (2, h, w, 16)), _i8(rng, (3, 3, 16, 16), -40, 41),
            _f32(0.0005 + 0.001 * rng.random(16)), _f32(rng.normal(size=16))]
    args = [a.to(cuda) for a in args]
    want = conv_i8.conv_i8_exact_plain(*args, pm_scale=pm)
    got = conv_i8.conv_i8_exact(*args, pm_scale=pm)
    torch.cuda.synchronize()
    for g, wnt in zip(got if pm else [got], want if pm else [want]):
        assert torch.equal(g, wnt)


def test_conv_i8_dual_and_in1_cuda(rng, cuda):
    x, z = _i8(rng, (2, 48, 64, 16)), _i8(rng, (2, 48, 64, 16))
    wx, wz = _i8(rng, (3, 3, 16, 16), -40, 41), _i8(rng, (3, 3, 16, 16), -40, 41)
    sx, sz = _f32(0.0005 + 0.001 * rng.random(16)), _f32(0.0005 + 0.001 * rng.random(16))
    b = _f32(rng.normal(size=16))
    args = [a.to(cuda) for a in (x, z, wx, wz, sx, sz, b)]
    assert torch.equal(conv_i8.conv_i8_exact_dual(*args), conv_i8.conv_i8_exact_dual_plain(*args))
    args = [a.to(cuda) for a in (x[..., 0], z[..., 0], _i8(rng, (3, 3, 2, 16)), sx, b)]
    assert torch.equal(conv_i8.conv_i8_in1_split(*args), conv_i8.conv_i8_in1_split_plain(*args))


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
                                      (128, 64), (64, 32), (32, 16), (16, 1)])
def test_conv_i8_generic_cuda(rng, cuda, cin, cout):
    args = [_i8(rng, (2, 24, 40, cin)), _i8(rng, (3, 3, cin, cout)),
            _f32(0.0005 + 0.001 * rng.random(cout)), _f32(rng.normal(size=cout))]
    args = [a.to(cuda) for a in args]
    got = conv_i8.conv_i8_generic(*args)
    assert torch.equal(got, conv_i8.conv_i8_generic_plain(*args))
