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

from sifsr_tpu_torch.kernels import conv_i8, conv_px, fused_ops, resize_phases

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


@pytest.mark.parametrize("n", [1, 3, 13])
@pytest.mark.parametrize("factor,kind,size,c", [(4, "cubic", 64, 1), (2, "linear_ac", 128, 16)])
@pytest.mark.parametrize("scale", [None, 0.02])
def test_upsample_phases_serving_shapes_cuda(rng, cuda, n, factor, kind, size, c, scale):
    """Kernel A at the serving calls' shapes (R = 32 rows a block for the
    cubic x4 of 64² x 1, R = 4 for the x2 of 128² x 16) on batches 1, 3 and
    13: identical to the plain version, int8 and float32 out."""
    x = _f32(3.0 * rng.standard_normal((n, size, size, c))).to(cuda)
    got = resize_phases.upsample_phases(x, factor, kind, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, resize_phases.upsample_phases_plain(x, factor, kind, scale))


@pytest.mark.parametrize("h,w,c,factor,kind", [
    (40, 36, 3, 4, "cubic"), (40, 36, 3, 2, "linear_ac"), (40, 37, 16, 2, "linear_ac"),
    (40, 36, 16, 4, "cubic"), (40, 36, 1, 2, "cubic"), (9, 7, 5, 3, "cubic"),
    (3, 908, 64, 2, "linear_ac"), (2, 4001, 14, 2, "linear_ac")])
@pytest.mark.parametrize("scale", [None, 0.02])
def test_upsample_phases_odd_shapes_cuda(rng, cuda, h, w, c, factor, kind, scale):
    """Kernel A's generic form (3 and 5 channels, factor 2 and 3 at one
    channel), odd widths at 16 channels, and the widest rows the
    one-row-a-block kernel took (908 x 64 and 4001 x 14 floats: 227 KB and
    just under, R = 1); then the same input 4 bytes past a 16-byte boundary
    (the scalar row pass). Identical to the plain version."""
    x = _f32(3.0 * rng.standard_normal((2, h, w, c)))
    want = resize_phases.upsample_phases_plain(x.to(cuda), factor, kind, scale)
    got = resize_phases.upsample_phases(x.to(cuda), factor, kind, scale)
    x1 = torch.cat([torch.zeros(1), x.reshape(-1)]).to(cuda)[1:].reshape(x.shape)
    got1 = resize_phases.upsample_phases(x1, factor, kind, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got1, want)


@pytest.mark.parametrize("h,w,c,factor,kind", [(9, 7, 5, 3, "cubic"), (9, 12, 1, 3, "cubic"),
                                               (9, 12, 4, 3, "cubic"), (16, 16, 1, 4, "cubic"),
                                               (16, 16, 16, 2, "linear_ac")])
@pytest.mark.parametrize("scale", [1.0, 0.5, 2.0])
def test_upsample_phases_ties_and_saturation_cuda(rng, cuda, h, w, c, factor, kind, scale):
    """The int8 epilogue on half-integer values (factor 3 keeps every third
    row and column as it is, so x = k + 0.5 at scale 1 rounds half to even
    there) and on values far past +-127: identical to the plain version."""
    x = _f32(rng.integers(-200, 200, (2, h, w, c)) + 0.5)
    x[0, 0, 0, 0], x[0, 1, 1, 0] = 1e30, -1e30
    x = x.to(cuda)
    got = resize_phases.upsample_phases(x, factor, kind, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, resize_phases.upsample_phases_plain(x, factor, kind, scale))


@pytest.mark.parametrize("c,factor,kind", [(1, 4, "cubic"), (16, 2, "linear_ac"),
                                           (3, 4, "cubic")])
@pytest.mark.parametrize("out_int8", [True, False])
def test_upsample_phases_misaligned_output_cuda(rng, cuda, c, factor, kind, out_int8):
    """The entry called with an output that starts one element past a
    16-byte boundary (the wrapper always allocates its own; the entry takes
    any pointer): the generic form, scalar stores, identical to the plain
    version."""
    import ctypes

    x = _f32(3.0 * rng.standard_normal((3, 40, 36, c))).to(cuda)
    scale = 0.02 if out_int8 else None
    want = resize_phases.upsample_phases_plain(x, factor, kind, scale)
    deltas, rc, cc = resize_phases._device_tables(40, 36, factor, kind, x.device)
    buf = torch.zeros(want.numel() + 1, dtype=want.dtype, device=cuda)
    out = buf[1:].view(want.shape)
    lib = resize_phases._lib()
    code = lib.sifsr_upsample_phases(
        x.data_ptr(), rc.data_ptr(), cc.data_ptr(), (ctypes.c_int * len(deltas))(*deltas),
        len(deltas), factor, 3, 40, 36, c, resize_phases._launch_shape(40, 36, c, factor)[0],
        resize_phases._inv_scale(scale) if out_int8 else 1.0, int(out_int8), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    assert torch.equal(out, want) and int(buf[0]) == 0


@pytest.mark.parametrize("rows", [0, 2])
def test_upsample_phases_entry_refuses_rows_past_shared_memory_cuda(cuda, rows):
    """The entry checks the R it is given: none, or 2 rows of the widest row
    (908 x 64 floats, 227 KB each), is refused with cudaErrorInvalidValue
    before any launch; the output stays untouched."""
    import ctypes

    x = torch.zeros((1, 3, 908, 64), device=cuda)
    deltas, rc, cc = resize_phases._device_tables(3, 908, 2, "linear_ac", x.device)
    out = torch.full((1, 6, 1816, 64), 5.0, device=cuda)
    code = resize_phases._lib().sifsr_upsample_phases(
        x.data_ptr(), rc.data_ptr(), cc.data_ptr(), (ctypes.c_int * len(deltas))(*deltas),
        len(deltas), 2, 1, 3, 908, 64, rows, 1.0, 0, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert code == 1 and bool((out == 5.0).all())


@pytest.mark.parametrize("h,w,c,factor,kind", [(40, 36, 3, 4, "cubic"), (64, 64, 1, 4, "cubic")])
def test_upsample_phases_int8_input_cuda(rng, cuda, h, w, c, factor, kind):
    """The int8 input with in_scale (cast to float32 by the wrapper, the
    scale folded into the row coefficients): identical to the plain
    version."""
    x = _i8(rng, (2, h, w, c)).to(cuda)
    got = resize_phases.upsample_phases(x, factor, kind, scale=0.02, in_scale=0.05)
    torch.cuda.synchronize()
    assert torch.equal(got, resize_phases.upsample_phases_plain(x, factor, kind, 0.02, 0.05))


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


# Tilings of kernels B and C on the int8 tensor cores (32x32 output tiles for
# B, 16x32 for C, persistent grids of k x the SM count): batch 1, H and W off
# the tile (even, as the phase mean needs; odd without it), and a batch whose
# tiles outnumber the grid by a remainder (13 x 64 and 13 x 128 tiles).
EXACT_SHAPES = [(1, 64, 64), (2, 66, 130), (2, 66, 100), (13, 256, 256)]
EXACT_CASES = [(*s, pm) for s in EXACT_SHAPES for pm in (None, 0.17)] + [(3, 37, 45, None)]


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape and torch.equal(g, wnt)


@pytest.mark.parametrize("n,h,w,pm", EXACT_CASES)
def test_conv_i8_exact_tilings_cuda(rng, cuda, n, h, w, pm):
    """Kernel B, with and without the fused phase mean, bit for bit against
    its plain version where a tiling breaks; one launch a call."""
    args = _conv_args(rng, cuda, n, h, w, 16, 16)
    conv_i8.conv_i8_exact.launches = 0
    got = conv_i8.conv_i8_exact(*args, pm_scale=pm)
    torch.cuda.synchronize()
    assert conv_i8.conv_i8_exact.launches == 1
    _same(got, conv_i8.conv_i8_exact_plain(*args, pm_scale=pm))


@pytest.mark.parametrize("pm", [None, 0.17])
@pytest.mark.parametrize("mode", ["mixed", "max"])
def test_conv_i8_exact_saturating_cuda(rng, cuda, mode, pm):
    """Kernel B with every input and weight at +-127 (accumulators up to
    9 * 16 * 127^2 = 2,322,576)."""
    args = _sat_args(rng, cuda, 2, 40, 36, 16, 16, mode)
    got = conv_i8.conv_i8_exact(*args, pm_scale=pm)
    torch.cuda.synchronize()
    want = conv_i8.conv_i8_exact_plain(*args, pm_scale=pm)
    _same(got, want)
    assert float((want[0] if pm else want).float().abs().mean()) > 2.0


@pytest.mark.parametrize("n,h,w", EXACT_SHAPES + [(3, 37, 45)])
def test_conv_i8_exact_dual_tilings_cuda(rng, cuda, n, h, w):
    """Kernel C, bit for bit against its plain version where a tiling
    breaks; one launch a call."""
    x, wx, sx, b = _conv_args(rng, cuda, n, h, w, 16, 16)
    z, wz, sz, _ = _conv_args(rng, cuda, n, h, w, 16, 16)
    conv_i8.conv_i8_exact_dual.launches = 0
    got = conv_i8.conv_i8_exact_dual(x, z, wx, wz, sx, sz, b)
    torch.cuda.synchronize()
    assert conv_i8.conv_i8_exact_dual.launches == 1
    _same(got, conv_i8.conv_i8_exact_dual_plain(x, z, wx, wz, sx, sz, b))


@pytest.mark.parametrize("mode", ["mixed", "max"])
def test_conv_i8_exact_dual_saturating_cuda(rng, cuda, mode):
    """Kernel C with every input and weight at +-127, both inputs."""
    x, wx, sx, b = _sat_args(rng, cuda, 3, 40, 36, 16, 16, mode)
    z, wz, sz, _ = _sat_args(rng, cuda, 3, 40, 36, 16, 16, mode)
    got = conv_i8.conv_i8_exact_dual(x, z, wx, wz, sx, sz, b)
    torch.cuda.synchronize()
    want = conv_i8.conv_i8_exact_dual_plain(x, z, wx, wz, sx, sz, b)
    _same(got, want)
    assert float(want.float().abs().mean()) > 2.0


@pytest.mark.parametrize("kind", ["exact", "exact_pm", "exact_dual"])
def test_conv_i8_exact_launch_cuda(cuda, kind):
    """B's and C's persistent grids at the serving shape (324 x 256²: 20,736
    tiles of 32x32 for B, 41,472 of 16x32 for C): a whole number of blocks on
    every SM, within the card's shared memory; one block for one tile."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = conv_px.tensor_core_launch(kind, 324, 256, 256, 16, 16)
    assert got["tiles"] == 324 * (256 // (16 if kind == "exact_dual" else 32)) * 8
    assert 0 < got["smem_bytes"] <= 232448, got
    assert got["blocks"] % sms == 0 and got["blocks"] < got["tiles"], got
    assert conv_px.tensor_core_launch(kind, 1, 16, 32, 16, 16)["blocks"] == 1
    with pytest.raises(ValueError):
        conv_px.tensor_core_launch(kind, 1, 16, 32, 32, 32)


@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
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


def _sat_args(rng, cuda, n, h, w, cin, cout, mode):
    """Saturating int8 operands: 'mixed' has inputs and weights of +-127 with
    random signs, 'max' all +127 (the largest accumulator, 9*cin*127^2 =
    9,290,304 at 64 channels), 'min' inputs all -127 and weights all +127 (the
    most negative), 'alternating' +-127 in a checkerboard over pixels and
    channels (weights over taps and channels), 'coherent' the signs of x and
    w aligned over the input channels (w = 127 s[ci] t[co], x = 127 s[ci] r
    with r = +-1 on 4x4 pixel blocks, one value in 32 flipped), so that most
    accumulators are near the largest and differ from pixel to pixel. The
    scales put the outputs mid-range, so the float32 epilogue rounds at large
    accumulator values."""
    if mode in ("max", "min"):
        x = np.full((n, h, w, cin), 127 if mode == "max" else -127, np.int8)
        wt = np.full((3, 3, cin, cout), 127, np.int8)
        acc = 9 * cin * 127.0 * 127.0
    elif mode == "alternating":
        yy, xx, cc = np.ogrid[:h, :w, :cin]
        x = np.broadcast_to((127 * (-1) ** (yy + xx + cc)).astype(np.int8), (n, h, w, cin))
        tt, ci, co = np.ogrid[:9, :cin, :cout]
        wt = (127 * (-1) ** (tt + ci + co)).astype(np.int8).reshape(3, 3, cin, cout)
        x = np.ascontiguousarray(x)
        acc = 9 * cin * 127.0 * 127.0
    elif mode == "coherent":
        s, t = rng.choice([-1, 1], cin), rng.choice([-1, 1], cout)
        r = np.kron(rng.choice([-1, 1], (n, h // 4 + 1, w // 4 + 1)),
                    np.ones((1, 4, 4)))[:, :h, :w]
        f = np.where(rng.random((n, h, w, cin)) < 1 / 32, -1, 1)
        x = (127 * r[..., None] * s * f).astype(np.int8)
        wt = np.ascontiguousarray(
            np.broadcast_to(127 * s[:, None] * t[None, :], (3, 3, cin, cout)), np.int8)
        acc = 9 * cin * 127.0 * 127.0
    else:
        x = (127 * rng.choice([-1, 1], (n, h, w, cin))).astype(np.int8)
        wt = (127 * rng.choice([-1, 1], (3, 3, cin, cout))).astype(np.int8)
        acc = 127.0 * 127.0 * np.sqrt(9 * cin)
    args = [torch.from_numpy(x), torch.from_numpy(wt),
            _f32(40.0 / acc * (0.5 + rng.random(cout))), _f32(rng.normal(0.0, 5.0, cout))]
    return [a.to(cuda) for a in args]


# Tilings of the tensor-core kernels (8x32 output tiles for J, 8x32 source
# tiles for I at 64 input channels and 16x32 for K at 32, persistent grids
# of k x the SM count): batch 1, H and W
# off the tile, and batches whose tile count passes the grid by a remainder.
# (The x2 tables of up2_coeffs_mxu take at most 128 source pixels a side.)
DUAL_SHAPES = [(1, 64, 64), (2, 66, 130), (7, 128, 128), (19, 64, 64)]
UP2_SHAPES = [(1, 32, 32), (2, 66, 100), (53, 64, 64)]


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("n,h,w", DUAL_SHAPES)
def test_conv_prow_dual_planes_tilings_cuda(rng, cuda, c, n, h, w):
    """Kernel J on the int8 tensor cores, bit for bit against its plain
    version where a tiling breaks."""
    x, wx, sx, b = _conv_args(rng, cuda, n, h, w, c, c)
    z, wz, sz, _ = _conv_args(rng, cuda, n, h, w, c, c)
    got = conv_px.conv_prow_dual_planes(x, z, wx, wz, sx, sz, b)
    torch.cuda.synchronize()
    assert torch.equal(got, conv_px.conv_prow_dual_planes_plain(x, z, wx, wz, sx, sz, b))


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("mode", ["mixed", "max"])
def test_conv_prow_dual_planes_saturating_cuda(rng, cuda, c, mode):
    """Kernel J with every input and weight at +-127: int32 accumulators up
    to 9.3 M a input and the float32 epilogue at those values."""
    x, wx, sx, b = _sat_args(rng, cuda, 3, 40, 36, c, c, mode)
    z, wz, sz, _ = _sat_args(rng, cuda, 3, 40, 36, c, c, mode)
    got = conv_px.conv_prow_dual_planes(x, z, wx, wz, sx, sz, b)
    torch.cuda.synchronize()
    want = conv_px.conv_prow_dual_planes_plain(x, z, wx, wz, sx, sz, b)
    assert torch.equal(got, want)
    assert float(want.float().abs().mean()) > 2.0


def _up2_tables(cuda, h, w, table):
    make = conv_px.up2_coeffs_mxu if table == "mxu" else conv_px.up2_coeffs
    a, b, inv = make(h, w, 0.05, 0.0625)
    return [torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda), inv]


@pytest.mark.parametrize("table", ["mxu", "vpu"])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 32), (32, 16)])
@pytest.mark.parametrize("n,h,w", UP2_SHAPES)
def test_conv_prow_up2_tilings_cuda(rng, cuda, table, cin, cout, n, h, w):
    """Kernels I (64->64, 64->32) and K (32->16) on the int8 tensor cores,
    both x2 tables, bit for bit against their plain versions where a tiling
    breaks."""
    args = _conv_args(rng, cuda, n, h, w, cin, cout)
    tables = _up2_tables(cuda, h, w, table)
    kernel = conv_px.conv_prow_up2_pack if cout == 16 else conv_px.conv_prow_up2
    got = kernel(*args, *tables)
    torch.cuda.synchronize()
    assert got.shape == (n, 2 * h, 2 * w, cout)
    assert torch.equal(got, conv_px.conv_prow_up2_plain(*args, *tables))


@pytest.mark.parametrize("table", ["mxu", "vpu"])
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 32), (32, 16)])
@pytest.mark.parametrize("mode", ["mixed", "max"])
def test_conv_prow_up2_saturating_cuda(rng, cuda, table, cin, cout, mode):
    """Kernels I and K with every input and weight at +-127."""
    args = _sat_args(rng, cuda, 2, 40, 36, cin, cout, mode)
    tables = _up2_tables(cuda, 40, 36, table)
    kernel = conv_px.conv_prow_up2_pack if cout == 16 else conv_px.conv_prow_up2
    got = kernel(*args, *tables)
    torch.cuda.synchronize()
    assert torch.equal(got, conv_px.conv_prow_up2_plain(*args, *tables))


def test_tensor_core_launch_cuda(cuda):
    """The persistent grids at the serving shapes: a whole number of blocks
    on every SM (or one a tile), within the card's shared memory."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind, hw, cin, cout in (("dual", 64, 64, 64), ("dual", 128, 32, 32), ("up2", 32, 64, 64),
                                ("up2", 64, 64, 32), ("up2_vpu", 128, 32, 16)):
        got = conv_px.tensor_core_launch(kind, 324, hw, hw, cin, cout)
        assert 0 < got["smem_bytes"] <= 232448, (kind, got)
        assert got["blocks"] % sms == 0 and got["blocks"] < got["tiles"], (kind, got)
    assert conv_px.tensor_core_launch("dual", 1, 8, 32, 64, 64)["blocks"] == 1


# Tilings of kernels G and H on the int8 tensor cores (at 16 input channels
# the kernel B and C share, on 32x32 output tiles; at 32 and 64 channels
# 16x32 and 8x32 tiles walked in units of two rows by 16 columns; persistent
# grids of k x the SM count): batch 1, H and W off the tile on both axes
# (for H even, as its pool needs, with an odd number of pool cells on one or
# both axes; for G also odd), and a batch of 128² images whose tiles
# outnumber the grid by a remainder (464, 928 and 1,856 tiles).
PROW_TILINGS = [(1, 64, 64), (2, 40, 36), (2, 66, 100), (3, 37, 45), (29, 128, 128)]
POOL_TILINGS = [(1, 64, 64), (2, 40, 36), (2, 66, 100), (2, 34, 50), (29, 128, 128)]


def _residual(rng, cuda, n, h, w, c, sat=False):
    if sat:
        return torch.from_numpy((127 * rng.choice([-1, 1], (n, h, w, c))).astype(np.int8)).to(cuda)
    return _i8(rng, (n, h, w, c)).to(cuda)


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,h,w", PROW_TILINGS)
def test_conv_prow_tilings_cuda(rng, cuda, c, residual, n, h, w):
    """Kernel G, with and without the fused residual, bit for bit against
    its plain version where a tiling breaks; one launch a call."""
    args = _conv_args(rng, cuda, n, h, w, c, c)
    kw = dict(residual=_residual(rng, cuda, n, h, w, c), res_sc=0.73) if residual else {}
    conv_px.conv_prow.launches = 0
    got = conv_px.conv_prow(*args, **kw)
    torch.cuda.synchronize()
    assert conv_px.conv_prow.launches == 1
    _same(got, conv_px.conv_prow_plain(*args, **kw))


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("mode", ["mixed", "max", "coherent"])
def test_conv_prow_saturating_cuda(rng, cuda, c, residual, mode):
    """Kernel G with every input, weight and residual value at +-127: int32
    accumulators up to 9 * c * 127^2 (past 2^22 at 32 and 64 channels) and
    the float32 epilogue at those values."""
    args = _sat_args(rng, cuda, 2, 40, 36, c, c, mode)
    kw = dict(residual=_residual(rng, cuda, 2, 40, 36, c, sat=True), res_sc=0.11) \
        if residual else {}
    got = conv_px.conv_prow(*args, **kw)
    torch.cuda.synchronize()
    want = conv_px.conv_prow_plain(*args, **kw)
    _same(got, want)
    assert float(want.float().abs().mean()) > 2.0


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 64)])
@pytest.mark.parametrize("n,h,w", POOL_TILINGS)
def test_conv_prow_split_pool_tilings_cuda(rng, cuda, cin, cout, n, h, w):
    """Kernel H, the skip and the pool bit for bit against its plain version
    where a tiling breaks; one launch a call."""
    args = _conv_args(rng, cuda, n, h, w, cin, cout)
    conv_px.conv_prow_split_pool.launches = 0
    got = conv_px.conv_prow_split_pool(*args, 0.21)
    torch.cuda.synchronize()
    assert conv_px.conv_prow_split_pool.launches == 1
    _same(got, conv_px.conv_prow_split_pool_plain(*args, 0.21))


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 64)])
@pytest.mark.parametrize("mode", ["mixed", "max", "coherent"])
def test_conv_prow_split_pool_saturating_cuda(rng, cuda, cin, cout, mode):
    """Kernel H with every input and weight at +-127."""
    args = _sat_args(rng, cuda, 2, 40, 36, cin, cout, mode)
    got = conv_px.conv_prow_split_pool(*args, 0.21)
    torch.cuda.synchronize()
    want = conv_px.conv_prow_split_pool_plain(*args, 0.21)
    _same(got, want)
    assert float(want[0].float().abs().mean()) > 2.0


@pytest.mark.parametrize("kind,hw,cin,cout", [
    ("prow", 128, 16, 16), ("prow_res", 128, 16, 16), ("prow", 64, 32, 32),
    ("prow_res", 64, 32, 32), ("prow", 32, 64, 64), ("prow_res", 32, 64, 64),
    ("pool", 128, 16, 32), ("pool", 64, 32, 64)])
def test_conv_prow_launch_cuda(cuda, kind, hw, cin, cout):
    """G's and H's persistent grids at the serving shapes (batch 324): a
    whole number of blocks on every SM, within the card's shared memory; one
    block for one tile; no launch for a shape the entry is not built for."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = conv_px.tensor_core_launch(kind, 324, hw, hw, cin, cout)
    assert 0 < got["smem_bytes"] <= 232448, got
    assert got["blocks"] % sms == 0 and got["blocks"] < got["tiles"], got
    assert got["tiles"] in [324 * (hw // th) * (hw // 32) for th in (8, 16, 32)], got
    assert conv_px.tensor_core_launch(kind, 1, 8, 32, cin, cout)["blocks"] == 1
    with pytest.raises(RuntimeError):
        conv_px.tensor_core_launch(kind, 1, 8, 32, cin, 2 * cout)


@pytest.mark.parametrize("h,w", [(64, 64), (40, 36)])
def test_conv_i8_in1_and_outlay_cuda(rng, cuda, h, w):
    """Kernels E (identical to its plain version and to kernel D on the
    de-interleaved planes) and F (identical to its plain version and to the
    generic conv on the same operands)."""
    x2 = _i8(rng, (2, h, w, 2)).to(cuda)
    args = [a.to(cuda) for a in (_i8(rng, (3, 3, 2, 16)), _f32(0.0005 + 0.001 * rng.random(16)),
                                 _f32(rng.normal(size=16)))]
    got = conv_i8.conv_i8_in1(x2, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, conv_i8.conv_i8_in1_plain(x2, *args))
    assert torch.equal(got, conv_i8.conv_i8_in1_split(x2[..., 0].contiguous(),
                                                      x2[..., 1].contiguous(), *args))
    args = [a.to(cuda) for a in (_i8(rng, (2, h, w, 16)), _i8(rng, (3, 3, 16, 1)),
                                 _f32([0.0011]), _f32([301.5]))]
    got = conv_i8.conv_i8_outlay(*args)
    torch.cuda.synchronize()
    assert got.shape == (2, h, w) and got.dtype == torch.float32
    assert torch.equal(got, conv_i8.conv_i8_outlay_plain(*args))
    assert torch.equal(got, conv_i8.conv_i8_generic(*args, relu=False)[..., 0])


@pytest.mark.parametrize("c", [32, 64])
def test_conv_prow_dual_cuda(rng, cuda, c):
    """Kernel L (J's entry point under its own wrapper and launch count)."""
    x, wx, sx, b = _conv_args(rng, cuda, 2, 40, 36, c, c)
    z, wz, sz, _ = _conv_args(rng, cuda, 2, 40, 36, c, c)
    conv_px.conv_prow_dual.launches = conv_px.conv_prow_dual_planes.launches = 0
    got = conv_px.conv_prow_dual(x, z, wx, wz, sx, sz, b)
    torch.cuda.synchronize()
    assert (conv_px.conv_prow_dual.launches, conv_px.conv_prow_dual_planes.launches) == (1, 0)
    assert torch.equal(got, conv_px.conv_prow_dual_plain(x, z, wx, wz, sx, sz, b))


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 32), (32, 16)])
def test_conv_prow_up2_vpu_cuda(rng, cuda, cin, cout):
    """Kernels I and K with the float32 tables (up2_impl='vpu') on 40x36
    sources: identical to the plain chain and to kernel A with in_scale on
    the conv's int8 output (s_up exact in float32, so both form the same
    1/s_up)."""
    s_mid, s_up = 0.05, 0.0625
    args = _conv_args(rng, cuda, 2, 40, 36, cin, cout)
    rc, cc, inv = conv_px.up2_coeffs(40, 36, s_mid, s_up)
    tables = [torch.from_numpy(rc).to(cuda), torch.from_numpy(cc).to(cuda), inv]
    kernel = conv_px.conv_prow_up2_pack if cout == 16 else conv_px.conv_prow_up2
    got = kernel(*args, *tables)
    torch.cuda.synchronize()
    assert got.shape == (2, 80, 72, cout)
    assert torch.equal(got, conv_px.conv_prow_up2_plain(*args, *tables))
    mid = conv_px.conv_prow_plain(*args)
    assert torch.equal(got, resize_phases.upsample_phases(mid, 2, "linear_ac", scale=s_up,
                                                          in_scale=s_mid))


MEAN, STD = 295.0, 10.0


@pytest.mark.parametrize("size", [64, 128])
def test_fused_psf_downscale_cuda(rng, cuda, size):
    """Kernel M forward and backward on an odd batch (64 -> 16, 128 -> 32)
    against the plain version in float64; 1e-5 covers float32 sums of
    `size` terms taken in another order."""
    x = _f32(rng.standard_normal((3, size, size)))
    g = _f32(rng.standard_normal((3, size // 4, size // 4)))
    xd = x.to(cuda).requires_grad_()
    fused_ops.fused_psf_downscale.launches = fused_ops.fused_psf_downscale.backward_launches = 0
    y = fused_ops.fused_psf_downscale(xd, MEAN, STD)
    # an expanded (stride-0) view must also do as the incoming gradient
    (dx,) = torch.autograd.grad(y, xd, g.to(cuda))
    (dx1,) = torch.autograd.grad(fused_ops.fused_psf_downscale(xd, MEAN, STD), xd,
                                 torch.ones((), device=cuda).expand(3, size // 4, size // 4))
    torch.cuda.synchronize()
    assert (fused_ops.fused_psf_downscale.launches,
            fused_ops.fused_psf_downscale.backward_launches) == (2, 2)
    x64 = x.double().requires_grad_()
    want = fused_ops.fused_psf_downscale_plain(x64, MEAN, STD)
    (want_dx,) = torch.autograd.grad(want, x64, g.double(), retain_graph=True)
    (want_dx1,) = torch.autograd.grad(want, x64, torch.ones_like(want))
    assert y.shape == (3, size // 4, size // 4) and dx.shape == x.shape
    assert float((y.detach().cpu().double() - want.detach()).abs().max()) <= 1e-5
    assert float((dx.cpu().double() - want_dx).abs().max()) <= 1e-5
    assert float((dx1.cpu().double() - want_dx1).abs().max()) <= 1e-5


def test_fused_psf_downscale_autograd_cuda(rng, cuda):
    """huber(fused_psf_downscale(x), t): value and gradient against the plain
    chain (value 1e-5, gradient rtol 1e-4 / atol 1e-6, the JAX package's own
    bounds for its kernel's gradient)."""
    from sifsr_tpu_torch.losses.losses import huber

    x = _f32(rng.standard_normal((3, 64, 64)))
    t = _f32(rng.standard_normal((3, 16, 16))).to(cuda)
    got_x, want_x = x.to(cuda).requires_grad_(), x.to(cuda).requires_grad_()
    got = huber(fused_ops.fused_psf_downscale(got_x, MEAN, STD), t)
    want = huber(fused_ops.fused_psf_downscale_plain(want_x, MEAN, STD), t)
    got.backward()
    want.backward()
    assert abs(float(got.detach()) - float(want.detach())) < 1e-5
    torch.testing.assert_close(got_x.grad, want_x.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("h,w", [(64, 64), (40, 36)])
@pytest.mark.parametrize("factor", [4, 2])
@pytest.mark.parametrize("renorm", [False, True])
def test_fused_norm_l4_cuda(rng, cuda, h, w, factor, renorm):
    """Kernel N against its float64 plain version, relative 1e-6 (on the
    un-normalised value when renorm is set: the final (y - mean)/std cancels
    the leading digits)."""
    x = _f32(rng.standard_normal((3, h, w)))
    got = fused_ops.fused_norm_l4(x.to(cuda), MEAN, STD, factor, renorm)
    torch.cuda.synchronize()
    want = fused_ops.fused_norm_l4_plain(x.double(), MEAN, STD, factor, renorm)
    assert got.shape == (3, h // factor, w // factor)
    got, scale = got.cpu().double(), want.abs()
    if renorm:
        got, want = got * STD + MEAN, want * STD + MEAN
        scale = want.abs()
    assert float(((got - want).abs() / scale).max()) <= 1e-6
    # an input that is not 16-byte aligned takes the scalar loads
    x1 = torch.cat([torch.zeros(1), x.reshape(-1)]).to(cuda)[1:].reshape(3, h, w)
    got1 = fused_ops.fused_norm_l4(x1, MEAN, STD, factor, renorm)
    assert torch.equal(got1, fused_ops.fused_norm_l4(x.to(cuda), MEAN, STD, factor, renorm))


@pytest.mark.parametrize("n", [1, 3, 32])
@pytest.mark.parametrize("size", [64, 128, 256])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_fused_psf_downscale_band_cuda(rng, cuda, n, size, factor):
    """Kernel M on bands of 8, 12 and 20 coefficients forward (factor 2, 4,
    8) and of 4, 3 and 3 backward: forward, backward and the expanded
    gradient within 1e-5 of the plain version in float64; one launch each
    way a call."""
    out = size // factor
    x = _f32(rng.standard_normal((n, size, size)))
    g = _f32(rng.standard_normal((n, out, out)))
    xd = x.to(cuda).requires_grad_()
    fused_ops.fused_psf_downscale.launches = fused_ops.fused_psf_downscale.backward_launches = 0
    y = fused_ops.fused_psf_downscale(xd, MEAN, STD, factor)
    (dx,) = torch.autograd.grad(y, xd, g.to(cuda))
    (dx1,) = torch.autograd.grad(fused_ops.fused_psf_downscale(xd, MEAN, STD, factor), xd,
                                 torch.ones((), device=cuda).expand(n, out, out))
    torch.cuda.synchronize()
    assert (fused_ops.fused_psf_downscale.launches,
            fused_ops.fused_psf_downscale.backward_launches) == (2, 2)
    x64 = x.double().requires_grad_()
    want = fused_ops.fused_psf_downscale_plain(x64, MEAN, STD, factor)
    (want_dx,) = torch.autograd.grad(want, x64, g.double(), retain_graph=True)
    (want_dx1,) = torch.autograd.grad(want, x64, torch.ones_like(want))
    assert y.shape == (n, out, out) and dx.shape == dx1.shape == x.shape
    assert float((y.detach().cpu().double() - want.detach()).abs().max()) <= 1e-5
    assert float((dx.cpu().double() - want_dx).abs().max()) <= 1e-5
    assert float((dx1.cpu().double() - want_dx1).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,size,factor", [(2, 256, 16), (2, 1024, 8), (1, 2048, 2),
                                            (1, 2050, 2), (1, 4096, 2), (1, 2048, 16)])
def test_fused_psf_downscale_large_shapes_cuda(rng, cuda, n, size, factor):
    """Kernel M past the recipes' shapes: a band of 36 (factor 16), staged
    rows of X in chunks of columns (1024² at factor 8, 2048² at factor 2;
    2050² also with rows no whole number of 16-byte words), 129 and 256 row
    tiles launched in turns of 128 (2050², 4096²), 16 rows a block
    backward (4096²): value and gradient within 1e-5 of float64, one launch
    each way."""
    out = size // factor
    x = _f32(rng.standard_normal((n, size, size)))
    g = _f32(rng.standard_normal((n, out, out)))
    f = fused_ops.fused_psf_downscale
    f.launches = f.backward_launches = 0
    xd = x.to(cuda).requires_grad_()
    y = f(xd, MEAN, STD, factor)
    (dx,) = torch.autograd.grad(y, xd, g.to(cuda))
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches) == (1, 1)
    x64 = x.double().to(cuda).requires_grad_()
    want = fused_ops.fused_psf_downscale_plain(x64, MEAN, STD, factor)
    (want_dx,) = torch.autograd.grad(want, x64, g.double().to(cuda))
    assert y.shape == (n, out, out) and dx.shape == x.shape
    assert float((y.detach().double() - want.detach()).abs().max()) <= 1e-5
    assert float((dx.double() - want_dx).abs().max()) <= 1e-5


@pytest.mark.parametrize("n,size,factor", [(4, 256, 31), (4, 256, 32), (4, 256, 64),
                                            (2, 256, 128), (2, 1024, 64), (1, 2048, 128)])
def test_fused_psf_downscale_wide_bands_cuda(rng, cuda, n, size, factor):
    """Kernel M on bands past 64 coefficients (factor 31: 66; 32: 68; 64:
    132; 128 at 256²: 194, a 2x2 output; 128 at 2048²: 260), whose step 2
    reads the coefficients from memory: value and gradient within 1e-5 of
    float64, one launch each way."""
    out = size // factor
    x = _f32(rng.standard_normal((n, size, size)))
    g = _f32(rng.standard_normal((n, out, out)))
    f = fused_ops.fused_psf_downscale
    f.launches = f.backward_launches = 0
    xd = x.to(cuda).requires_grad_()
    y = f(xd, MEAN, STD, factor)
    (dx,) = torch.autograd.grad(y, xd, g.to(cuda))
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches) == (1, 1)
    x64 = x.double().to(cuda).requires_grad_()
    want = fused_ops.fused_psf_downscale_plain(x64, MEAN, STD, factor)
    (want_dx,) = torch.autograd.grad(want, x64, g.double().to(cuda))
    assert y.shape == (n, out, out) and dx.shape == x.shape
    assert float((y.detach().double() - want.detach()).abs().max()) <= 1e-5
    assert float((dx.double() - want_dx).abs().max()) <= 1e-5


# sha256 (first 16 hex digits) of y and dx, as produced by the kernel before
# it took bands past 64 coefficients, on N(0, 1) inputs from
# default_rng(1000 * size + factor): the wide form left these shapes' bits as
# they were
_M_DIGESTS = {(32, 256, 4): "f2528a0ffb8d4f3e", (3, 64, 4): "a81c3ff08c87204a",
              (3, 128, 4): "d590d60640166f8d", (3, 256, 2): "e04bd3abb5f7b41d",
              (2, 256, 8): "593b8e3f82330d96", (4, 256, 16): "79114d87b3224296",
              (2, 1024, 8): "7fd2122e86ed1841", (1, 2048, 2): "44a70223289a8f1e",
              (3, 36, 4): "3de59b68081e09f2", (3, 42, 2): "8807b4f7df78234e",
              (1, 1024, 4): "c6e1b486be8b5a5e", (1, 2050, 2): "f55d02c64551c927"}


@pytest.mark.parametrize("n,size,factor", list(_M_DIGESTS))
def test_fused_psf_downscale_bits_unchanged_cuda(cuda, n, size, factor):
    """Kernel M at every band of up to 64 coefficients it took before the
    wide form: the forward's and the backward's bits are the earlier
    kernel's."""
    import hashlib

    rng = np.random.default_rng(1000 * size + factor)
    x = _f32(rng.standard_normal((n, size, size))).to(cuda).requires_grad_()
    g = _f32(rng.standard_normal((n, size // factor, size // factor))).to(cuda)
    y = fused_ops.fused_psf_downscale(x, MEAN, STD, factor)
    (dx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    h = hashlib.sha256(y.detach().cpu().numpy().tobytes() + dx.cpu().numpy().tobytes())
    assert h.hexdigest()[:16] == _M_DIGESTS[n, size, factor]


@pytest.mark.parametrize("size,factor", [(36, 4), (40, 4), (42, 2), (1024, 4)])
def test_fused_psf_downscale_odd_sizes_cuda(rng, cuda, size, factor):
    """Kernel M where a row of the image is no whole number of 16-byte words
    (36, 42: 4-byte copies), the output no multiple of 4 columns (9, 21: one
    column a thread backward too), on a batch that starts 4 bytes past a
    16-byte boundary, and at 1024² (the forward's stage of 48 rows of 4 KB,
    near the shared memory's end): forward and backward within 1e-5 of
    float64."""
    out = size // factor
    x = _f32(rng.standard_normal((3, size, size)))
    g = _f32(rng.standard_normal((3, out, out)))
    x64 = x.double().requires_grad_()
    want = fused_ops.fused_psf_downscale_plain(x64, MEAN, STD, factor)
    (want_dx,) = torch.autograd.grad(want, x64, g.double())
    for xd in (x.to(cuda), torch.cat([torch.zeros(1), x.reshape(-1)]).to(cuda)[1:].view(x.shape)):
        xd.requires_grad_()
        y = fused_ops.fused_psf_downscale(xd, MEAN, STD, factor)
        (dx,) = torch.autograd.grad(y, xd, g.to(cuda))
        torch.cuda.synchronize()
        assert float((y.detach().cpu().double() - want.detach()).abs().max()) <= 1e-5
        assert float((dx.cpu().double() - want_dx).abs().max()) <= 1e-5


@pytest.mark.parametrize("n", [1, 3, 32])
@pytest.mark.parametrize("h,w", [(64, 64), (64, 256), (256, 64), (256, 256)])
@pytest.mark.parametrize("factor", [4, 2])
@pytest.mark.parametrize("renorm", [False, True])
def test_fused_norm_l4_shapes_cuda(rng, cuda, n, h, w, factor, renorm):
    """Kernel N at the shapes of both callers: within 1e-6 relative of the
    float64 plain version (on the un-normalised value with renorm), one
    launch a call."""
    x = _f32(rng.standard_normal((n, h, w))).to(cuda)
    fused_ops.fused_norm_l4.launches = 0
    got = fused_ops.fused_norm_l4(x, MEAN, STD, factor, renorm)
    assert fused_ops.fused_norm_l4.launches == 1
    want = fused_ops.fused_norm_l4_plain(x.cpu().double(), MEAN, STD, factor, renorm)
    got64 = got.cpu().double()
    if renorm:
        got64, want = got64 * STD + MEAN, want * STD + MEAN
    assert got.shape == (n, h // factor, w // factor)
    assert float(((got64 - want).abs() / want.abs()).max()) <= 1e-6


@pytest.mark.parametrize("shape,factor", [((3, 8, 44), 4), ((2, 12, 20), 4), ((3, 42, 30), 2),
                                          ((1, 9, 27), 3)])
def test_fused_norm_l4_scalar_path_cuda(rng, cuda, shape, factor):
    """Kernel N's scalar path (factors other than 4, a misaligned input) and
    its float4 path at widths of an odd number of blocks:
    relative 1e-6 against float64, and a misaligned copy gives the aligned
    input's bits."""
    x = _f32(rng.standard_normal(shape))
    got = fused_ops.fused_norm_l4(x.to(cuda), MEAN, STD, factor)
    want = fused_ops.fused_norm_l4_plain(x.double(), MEAN, STD, factor)
    assert float(((got.cpu().double() - want).abs() / want.abs()).max()) <= 1e-6
    # the same values, contiguous, 4 bytes past a 16-byte boundary
    x1 = torch.cat([torch.zeros(1), x.reshape(-1)]).to(cuda)[1:].reshape(shape)
    assert x1.is_contiguous() and x1.data_ptr() % 16 == 4
    assert torch.equal(fused_ops.fused_norm_l4(x1, MEAN, STD, factor), got)


def test_degrade_batch_runs_norm_l4_kernel_cuda(rng, cuda):
    """The scale-invariance batch degradation launches kernel N once on the
    card and agrees with the CPU route (the kernel's plain version) to the
    float32 rounding of a Kelvin-scale value renormalised by std 10 (2e-5)."""
    from sifsr_tpu_torch.data.datasets import degrade_batch_scale_invariance

    batch = {"lst": rng.standard_normal((3, 64, 64, 1)).astype(np.float32),
             "ndvi": rng.standard_normal((3, 256, 256, 1)).astype(np.float32)}
    fused_ops.fused_norm_l4.launches = 0
    got = degrade_batch_scale_invariance(batch, MEAN, STD, device=cuda)
    assert fused_ops.fused_norm_l4.launches == 1
    want = degrade_batch_scale_invariance(batch, MEAN, STD, device="cpu")
    for k in want:
        assert got[k].shape == want[k].shape
        assert float((got[k].cpu() - want[k]).abs().max()) <= 2e-5, k


# Tilings of D, E (2 -> 16, 32x32 output tiles) and the outlay (16 -> 1,
# 32x32 tiles) on the int8 tensor cores, persistent grids of k x the SM
# count: batch 1 and 3, H and W of 8, 40, 72 and 256 (off the tile or
# shorter than it), odd sizes, and a batch whose tiles outnumber the grid by
# a remainder (13 x 64 tiles).
IN1_SHAPES = [(1, 8, 8), (1, 8, 40), (3, 40, 72), (1, 72, 40), (3, 37, 45), (3, 256, 40),
              (13, 256, 256)]
SAT_MODES = ["max", "min", "mixed", "alternating", "coherent"]


def _in1_args(rng, cuda, n, h, w, mode=None):
    """x (n,h,w,2) and D's weights, scale and bias; with ``mode`` saturating."""
    if mode is not None:
        return _sat_args(rng, cuda, n, h, w, 2, 16, mode)
    return [_i8(rng, (n, h, w, 2)).to(cuda)] + _conv_args(rng, cuda, 1, 1, 1, 2, 16)[1:]


def _check_in1(x, args, relu):
    """D on the planes and E on the interleaved tensor, each identical to its
    plain version, E to D; one launch each. Returns the plain output."""
    planes = (x[..., 0].contiguous(), x[..., 1].contiguous())
    conv_i8.conv_i8_in1_split.launches = conv_i8.conv_i8_in1.launches = 0
    d = conv_i8.conv_i8_in1_split(*planes, *args, relu=relu)
    e = conv_i8.conv_i8_in1(x, *args, relu=relu)
    torch.cuda.synchronize()
    assert conv_i8.conv_i8_in1_split.launches == conv_i8.conv_i8_in1.launches == 1
    want = conv_i8.conv_i8_in1_split_plain(*planes, *args, relu=relu)
    _same(d, want)
    _same(e, conv_i8.conv_i8_in1_plain(x, *args, relu=relu))
    _same(e, d)
    return want


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("n,h,w", IN1_SHAPES)
def test_conv_i8_in1_tilings_cuda(rng, cuda, n, h, w, relu):
    """Kernels D and E, bit for bit against their plain versions and each
    other where a tiling breaks."""
    x, *args = _in1_args(rng, cuda, n, h, w)
    _check_in1(x, args, relu)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("mode", SAT_MODES)
def test_conv_i8_in1_saturating_cuda(rng, cuda, mode, relu):
    """D and E with every input and weight at +-127: accumulators up to
    18 * 127^2 = 290,322 in magnitude, where the exact float conversion of
    the epilogue has to hold."""
    x, *args = _in1_args(rng, cuda, 3, 40, 72, mode)
    want = _check_in1(x, args, relu)
    if not (relu and mode == "min"):
        assert float(want.float().abs().mean()) > 2.0


def _check_outlay(x, wt, scale, bias):
    """F, and the generic conv at 16 -> 1 with and without the ReLU, each
    identical to its plain version, F to the generic conv; one launch each."""
    conv_i8.conv_i8_outlay.launches = conv_i8.conv_i8_generic.launches = 0
    f = conv_i8.conv_i8_outlay(x, wt, scale, bias)
    g = conv_i8.conv_i8_generic(x, wt, scale, bias, relu=False)
    gr = conv_i8.conv_i8_generic(x, wt, scale, bias, relu=True)
    torch.cuda.synchronize()
    assert conv_i8.conv_i8_outlay.launches == 1 and conv_i8.conv_i8_generic.launches == 2
    assert f.shape == x.shape[:3] and f.dtype == torch.float32
    want = conv_i8.conv_i8_outlay_plain(x, wt, scale, bias)
    _same(f, want)
    _same(g, conv_i8.conv_i8_generic_plain(x, wt, scale, bias, relu=False))
    _same(gr, conv_i8.conv_i8_generic_plain(x, wt, scale, bias, relu=True))
    _same(f, g[..., 0])
    return want


@pytest.mark.parametrize("n,h,w", IN1_SHAPES)
def test_conv_i8_outlay_tilings_cuda(rng, cuda, n, h, w):
    """The outlay kernel through both entries, bit for bit where a tiling
    breaks (the de-normalise folded into scale and bias, as the step does)."""
    x = _i8(rng, (n, h, w, 16)).to(cuda)
    wt = _i8(rng, (3, 3, 16, 1), -40, 41).to(cuda)
    _check_outlay(x, wt, _f32([0.0011]).to(cuda), _f32([301.5]).to(cuda))


@pytest.mark.parametrize("mode", SAT_MODES)
def test_conv_i8_outlay_saturating_cuda(rng, cuda, mode):
    """The outlay with every input and weight at +-127: accumulators up to
    144 * 127^2 = 2,322,576 in magnitude."""
    x, wt, scale, bias = _sat_args(rng, cuda, 3, 40, 72, 16, 1, mode)
    want = _check_outlay(x, wt, scale, bias)
    assert float(want.abs().mean()) > 2.0


@pytest.mark.parametrize("kind,cin,cout", [("in1_split", 2, 16), ("in1", 2, 16),
                                           ("outlay", 16, 1)])
def test_conv_i8_in1_outlay_launch_cuda(cuda, kind, cin, cout):
    """D's, E's and the outlay's persistent grids at the serving shape (324 x
    256²): a whole number of blocks on every SM, fewer than the tiles, within
    the card's shared memory; one block for one tile; no shape query for
    other channels."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = conv_px.tensor_core_launch(kind, 324, 256, 256, cin, cout)
    assert got["tiles"] in [324 * (256 // th) * 8 for th in (8, 16, 32)], got
    assert 0 < got["smem_bytes"] <= 232448, got
    assert got["blocks"] % sms == 0 and got["blocks"] < got["tiles"], got
    assert conv_px.tensor_core_launch(kind, 1, 8, 32, cin, cout)["blocks"] == 1
    assert conv_px.tensor_core_launch(kind, 1, 8, 8, cin, cout)["tiles"] == 1
    with pytest.raises(ValueError):
        conv_px.tensor_core_launch(kind, 1, 8, 32, 16, 16)


def test_lpips_cuda(cuda, tmp_path):
    """LPIPS on the card (full float32: no TF32) within 1e-5 relative of the
    same weights on the CPU, on three crops of odd sizes."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import write_lpips_weights
    from sifsr_tpu_torch.eval.lpips import LPIPS

    files = write_lpips_weights(str(tmp_path))
    card, host = LPIPS(*files, device=cuda), LPIPS(*files, device="cpu")
    rng = np.random.default_rng(3)
    for h, w in [(151, 163), (200, 187), (97, 140)]:
        a = rng.random((h, w)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        got, want = card(a, b), host(a, b)
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)


def test_device_metric_rows_cuda(cuda):
    """The batched metric block on the card against the same block on the
    CPU (2e-4, the bound against the host path: a threshold that moves by
    an ulp can move one pixel between strata)."""
    from sifsr_tpu_torch.eval.device_metrics import COLUMNS, device_metric_rows

    rng = np.random.default_rng(1)
    pairs = []
    for h, w in [(96, 128), (211, 97), (150, 151)]:
        yy, xx = np.mgrid[0:h, 0:w]
        base = 300.0 + 8.0 * np.sin(yy / 17.0) + 6.0 * np.cos(xx / 23.0)
        pairs.append((base + rng.normal(0, 0.8, (h, w)), base + rng.normal(0, 0.8, (h, w))))
    got, want = device_metric_rows(pairs, device=cuda), device_metric_rows(pairs, device="cpu")
    for g, w in zip(got, want):
        for col in COLUMNS:
            np.testing.assert_allclose(g[col], w[col], rtol=2e-4, atol=2e-4, err_msg=col)


def test_attenuation_spectrum_cuda(cuda):
    """The batched spectrum through cuFFT in float64 within 1e-5 dB of the
    float64 numpy form."""
    from sifsr_tpu_torch.eval.spectra import attenuation_spectrum, attenuation_spectrum_np

    img = (300.0 + np.random.default_rng(2).normal(0, 2.0, (3, 150, 161))).astype(np.float32)
    got = attenuation_spectrum(torch.from_numpy(img).to(cuda)).cpu().numpy()
    want = np.stack([attenuation_spectrum_np(im.astype(np.float64)) for im in img])
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5


def _dms_scene(n, seed=3, quantised=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:4 * n, 0:4 * n]
    ndvi = (0.3 + 0.25 * np.sin(yy / 9.0) + 0.2 * np.cos(xx / 7.0)
            + 0.05 * rng.standard_normal((4 * n, 4 * n)))
    lst = 310.0 - 18.0 * ndvi + 0.5 * rng.standard_normal(ndvi.shape)
    lst = lst.reshape(n, 4, n, 4).mean(axis=(1, 3))
    if quantised:  # MODIS's 0.02 K steps
        lst = np.round(lst / 0.02) * 0.02
    return lst.astype(np.float32), ndvi


@pytest.mark.parametrize("n,opts,quantised", [
    (16, {}, False), (32, {}, False), (64, {}, False), (16, {"moving_window_size": 8}, False),
    (32, {"per_leaf_linear_regression": False}, False), (32, {}, True), (64, {}, True)])
def test_dms_cuda(cuda, n, opts, quantised):
    """DMS with its bagged trees grown and applied on the card against the
    same on the CPU, on continuous and on 0.02 K-step LST: the same trees
    (segment sums in one order on both), the sharpened LST within 1e-4 K."""
    from sifsr_tpu_torch.baselines.dms import DecisionTreeSharpener

    lst, ndvi = _dms_scene(n, quantised=quantised)
    mw = opts.get("moving_window_size", 0)
    out = {}
    for dev in (cuda, "cpu"):
        s = DecisionTreeSharpener(factor=4, device=dev, **opts).train(ndvi, lst)
        out[str(dev)] = (s, s.residual_correction(s.apply(ndvi, lst if mw else None), lst))
    (card, got), (host, want) = out[str(cuda)], out["cpu"]
    regs = [(card.reg, host.reg)] + [(a[1], b[1]) for a, b in zip(card.local_regs,
                                                                   host.local_regs)]
    for a, b in regs:
        assert a.n_leaves() == b.n_leaves()
        for i in range(a.n_estimators):
            np.testing.assert_array_equal(a.thresholds(i), b.thresholds(i))
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 1e-4


def test_compare_methods_spectra_cuda(cuda, tmp_path):
    """``compare_methods spectra`` on the card against the CPU: the scores
    within 1e-6 relative."""
    import pickle

    import pandas as pd

    from sifsr_tpu_torch.cli import compare_methods

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:131, 0:140]
    for root in ("card", "cpu"):
        for m in ("bicubic", "m"):
            (tmp_path / root / m).mkdir(parents=True)
    for idx in range(3):
        aster = 300 + np.sin(yy / 2.5) * np.cos(xx / 3.1) + 0.2 * rng.normal(size=yy.shape)
        crops = {"bicubic": 300 + 0.5 * np.sin(yy / 2.5) * np.cos(xx / 3.1),
                 "m": 300 + 0.8 * np.sin(yy / 2.5) * np.cos(xx / 3.1)
                 + 0.05 * rng.normal(size=yy.shape)}
        for root in ("card", "cpu"):
            for m, c in crops.items():
                with open(tmp_path / root / m / f"{idx}_dict_pred.pkl", "wb") as f:
                    pickle.dump({"LST_ASTER": aster, "LST_SR": c}, f)
    perf = pd.DataFrame({"PSNR": [20.0, 21.0, 22.0]})
    for root, dev in (("card", "cuda"), ("cpu", "cpu")):
        perf.to_csv(tmp_path / root / "m" / "performances.csv")
        compare_methods.main(["spectra", "--results-dir", str(tmp_path / root), "--models", "m",
                              "--device", dev])
    got = pd.read_csv(tmp_path / "card" / "m" / "performances.csv", index_col=0)
    want = pd.read_csv(tmp_path / "cpu" / "m" / "performances.csv", index_col=0)
    cols = ["PFR", "AFR", "FRR", "FRO", "FRU"]
    np.testing.assert_allclose(got[cols].to_numpy(float)[:3], want[cols].to_numpy(float)[:3],
                               rtol=1e-6, atol=0)
