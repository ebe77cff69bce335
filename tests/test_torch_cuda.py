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

from sifsr_tpu_torch.kernels import conv_i8, conv_px, resize_phases

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


def _conv_args(rng, cuda, n, h, w, cin, cout):
    args = [_i8(rng, (n, h, w, cin)), _i8(rng, (3, 3, cin, cout), -40, 41),
            _f32(0.0005 + 0.001 * rng.random(cout)), _f32(rng.normal(size=cout))]
    return [a.to(cuda) for a in args]


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("residual", [False, True])
def test_conv_prow_cuda(rng, cuda, c, residual):
    """Kernel G on odd tile remainders (40x36 against 8x32 tiles)."""
    args = _conv_args(rng, cuda, 2, 40, 36, c, c)
    kw = dict(residual=_i8(rng, (2, 40, 36, c)).to(cuda), res_sc=0.73) if residual else {}
    want = conv_px.conv_prow_plain(*args, **kw)
    got = conv_px.conv_prow(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 64)])
def test_conv_prow_split_pool_cuda(rng, cuda, cin, cout):
    """Kernel H; 40x36 leaves partial tiles and pool cells at both edges."""
    args = _conv_args(rng, cuda, 2, 40, 36, cin, cout)
    want = conv_px.conv_prow_split_pool_plain(*args, 0.21)
    got = conv_px.conv_prow_split_pool(*args, 0.21)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 32), (32, 16)])
def test_conv_prow_up2_cuda(rng, cuda, cin, cout):
    """Kernels I (64->64, 64->32) and K (32->16) on 40x36 sources (6x30
    source tiles leave remainders on both axes)."""
    args = _conv_args(rng, cuda, 2, 40, 36, cin, cout)
    rnum, cnum, inv = conv_px.up2_coeffs_mxu(40, 36, 0.05, 0.06)
    tables = [torch.from_numpy(rnum).to(cuda), torch.from_numpy(cnum).to(cuda), inv]
    kernel = conv_px.conv_prow_up2_pack if cout == 16 else conv_px.conv_prow_up2
    want = conv_px.conv_prow_up2_plain(*args, *tables)
    got = kernel(*args, *tables)
    torch.cuda.synchronize()
    assert got.shape == (2, 80, 72, cout)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [32, 64])
def test_conv_prow_dual_planes_cuda(rng, cuda, c):
    """Kernel J (kernel C's template at 32 and 64 channels)."""
    x, wx, sx, b = _conv_args(rng, cuda, 2, 40, 36, c, c)
    z, wz, sz, _ = _conv_args(rng, cuda, 2, 40, 36, c, c)
    want = conv_px.conv_prow_dual_planes_plain(x, z, wx, wz, sx, sz, b)
    got = conv_px.conv_prow_dual_planes(x, z, wx, wz, sx, sz, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
