"""Kernels G-L: the int8 mid chain's convs with fused epilogues.

Counterparts, by function, of ``sifsr_tpu/pallas/conv_px.py``; CUDA source
``csrc/conv_px.cu``. All of them run on the int8 tensor cores
(``csrc/conv_mma.cuh``) in persistent blocks (``tensor_core_launch`` gives
their grid and shared memory): G and H at 16 input channels in the
16-channel kernel of ``csrc/conv16.cuh`` that B and C share, at 32 and 64
in a one-input kernel beside J's; I, J, K and L on the k32 loop:

- ``conv_prow`` (G): 3x3 conv + requantise, optionally with the residual add
  of DownBlock_pool fused before the requantise (db1-db3 res.conv1/conv2);
- ``conv_prow_split_pool`` (H): conv + requantise (the decoder skip) and the
  exact 2x2 pool of the requantised int8, requantised to the next level's
  input scale (db1/db2 lastconv);
- ``conv_prow_up2`` (I): conv + requantise at the mid scale + align-corners
  x2 + requantise (db3 lastconv, ub1.conv2);
- ``conv_prow_dual_planes`` (J): conv(concat(up, skip)) with per-half scales
  (ub1.conv1, ub2.conv1);
- ``conv_prow_up2_pack`` (K): I's function for ub2.conv2, the serving tail;
- ``conv_prow_dual`` (L): J with the skip as one tensor. In the port's NHWC
  layout the skip already is one tensor, so L's function is J's and it
  launches J's entry point; it keeps its own wrapper and launch count.

The TPU kernels hold tensors as p-pixel rows, split half-planes, e-major
pixel groups and space-to-depth pair rows, all to fill 128 TPU lanes; these
take and return the unpacked NHWC int8 tensors those stand for. The x2
upsamples are the integer-exact row mix of ``up2_impl='mxu'``
(``conv_px.py:752-808``): integer numerators over the rational
align-corners coefficients m / (2*size - 1), summed exactly, then one
float32 multiply by ``inv``, round half to even, clip. Given float32 tables
(``up2_coeffs``) instead, I and K run the roll/fma chain of
``up2_impl='vpu'`` (``conv_px.py:582-631``, ``:864-903``): a float32 row
pass with the mid scale folded into its coefficients, a float32 column pass,
then ``y * float32(1/s_up)``, round, clip: three roundings, bit-identical to
``upsample_phases(q, 2, 'linear_ac', scale=s_up, in_scale=s_mid)``.

Every wrapper checks device, dtype, shape and contiguity, launches on the
current stream and raises on a launch error; it runs its plain version only
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sifsr_tpu_torch.kernels import _build
from sifsr_tpu_torch.kernels.conv_i8 import _lib as _conv_i8_lib
from sifsr_tpu_torch.kernels.conv_i8 import (
    _check,
    _dequant,
    _device,
    _stream,
    conv3x3_i32,
    conv_i8_exact_dual_plain,
    conv_i8_exact_plain,
    quantize_kernel,
    requant,
)
from sifsr_tpu_torch.kernels.resize_phases import _coeff_arrays, _tables, phase_passes

__all__ = [
    "conv_prow", "conv_prow_split_pool", "conv_prow_up2", "conv_prow_dual_planes",
    "conv_prow_up2_pack", "conv_prow_plain", "conv_prow_split_pool_plain",
    "conv_prow_up2_plain", "conv_prow_dual_planes_plain", "conv_prow_up2_pack_plain",
    "conv_prow_dual", "conv_prow_dual_plain", "prow_leaf", "up2_coeffs_mxu", "up2_coeffs",
    "tensor_core_launch",
]

# (cin, cout) pairs each CUDA entry point is built for (csrc/conv_px.cu)
PROW_SHAPES = {(16, 16), (32, 32), (64, 64)}
POOL_SHAPES = {(16, 32), (32, 64)}
UP2_SHAPES = {(64, 64), (64, 32)}          # I: db3 lastconv, ub1.conv2
UP2_PACK_SHAPES = {(32, 16)}               # K: ub2.conv2
DUAL_CHANNELS = {32, 64}                   # J; 16 is kernel C


# ------------------------------------------------------------- parameters

def prow_leaf(kernel, bias, s_in, s_out=None, post_scale=1.0) -> dict:
    """One conv layer -> int8 HWIO weights + the folded per-channel
    scale/bias of the epilogue post(relu(acc*scale + bias)):
    scale = s_in*sw[/s_out]*post_scale, bias = b[/s_out]*post_scale.

    ``conv_px.prow_leaf`` without the banded packing and the tiling across
    pixel slots; the expressions are the same NumPy ones in the same order
    (``float * float32 array`` stays float32, the bias is float64 until the
    final cast), so the scales are bit-equal."""
    q, sw = quantize_kernel(kernel)
    comb = float(s_in) * sw * float(post_scale)
    b = np.asarray(bias, np.float64) * float(post_scale)
    if s_out is not None:
        comb, b = comb / float(s_out), b / float(s_out)
    return {"w": q, "scale": comb.astype(np.float32), "bias": b.astype(np.float32)}


def _int_numerators(coef: np.ndarray, denom: int) -> np.ndarray:
    """The exact integer numerators m of float32-rounded m/denom."""
    m = np.rint(coef.astype(np.float64) * denom)
    err = np.max(np.abs(m - coef.astype(np.float64) * denom))
    assert err < 0.01, (err, denom)
    return m


def _numerator_table(size: int) -> np.ndarray:
    """(2, 3, size) int32 numerators of the align-corners x2 over ``size``:
    [d, t, k] weighs source k-1+t for output 2k+d, zero where the tap leaves
    the axis."""
    deltas, coef = _coeff_arrays(size, 2, "linear_ac")
    num = _int_numerators(coef, 2 * size - 1)
    assert np.max(np.abs(num)) <= 2 * size - 1
    table = np.zeros((2, 3, size), np.int32)
    for j, delta in enumerate(deltas):
        assert delta in (-1, 0, 1), deltas
        table[:, delta + 1] = num[:, j]
    k = np.arange(size)
    assert not table[:, 0, k == 0].any() and not table[:, 2, k == size - 1].any()
    return table


def up2_coeffs_mxu(h: int, w: int, s_mid, s_up):
    """(rnum (2,3,h) int32, cnum (2,3,w) int32, inv float32) of the fused x2
    from an int8 tensor at ``s_mid`` to int8 at ``s_up``: the integer
    numerators and ``inv = s_mid / (D_r * D_c * s_up)`` of
    ``conv_px.up2_coeffs_mxu``, with the numerators per pixel rather than
    laid out for the MXU (its ``rm`` matrix and per-lane ``cc``). Exact in
    int32 and in float32 while D_r * D_c * 127 < 2^24."""
    d_r, d_c = 2 * h - 1, 2 * w - 1
    assert max(d_r, d_c) < 256 and d_r * d_c * 127 < 2 ** 24, (h, w)
    inv = np.float32(np.float64(s_mid) / (d_r * d_c * np.float64(s_up)))
    return _numerator_table(h), _numerator_table(w), inv


def up2_coeffs(h: int, w: int, s_mid, s_up):
    """(rc (2,3,h) float32, cc (2,3,w) float32, inv float32) of the fused x2
    in its ``up2_impl='vpu'`` form (``conv_px.up2_coeffs``): the stencil
    coefficients over the merged ascending deltas (-1, 0, 1), zero where a
    pass does not use a delta or the tap leaves the axis, the int8 dequantise
    scale ``s_mid`` folded into the row pass in float32, and
    ``inv = float32(1 / s_up)`` applied after the column pass. Per pixel
    rather than per lane (JAX repeats cc over the channels)."""
    deltas, rc, cc = _tables(h, w, 2, "linear_ac")
    assert deltas == (-1, 0, 1), deltas
    rc = rc * float(s_mid)
    return rc.astype(np.float32), cc.astype(np.float32), np.float32(1.0 / float(s_up))


# ---------------------------------------------------------- plain versions

def conv_prow_plain(x, w, scale, bias, relu=True, residual=None, res_sc=None):
    y = _dequant(conv3x3_i32(x, w), scale, bias)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if residual is not None:
        y = residual.to(torch.float32) * res_sc + y
    return requant(y, False)


def conv_prow_split_pool_plain(x, w, scale, bias, pool_sc, relu=True):
    return conv_i8_exact_plain(x, w, scale, bias, relu, pm_scale=pool_sc)


def _mix_matrix(table: torch.Tensor) -> torch.Tensor:
    """(2, 3, size) numerators -> (2*size, size) float64 row-mix matrix in
    output order (row 2k+d)."""
    size = table.shape[-1]
    m = torch.zeros((2 * size, size), dtype=torch.float64, device=table.device)
    k = torch.arange(size, device=table.device)
    for d in range(2):
        for t in range(3):
            src = k + t - 1
            ok = (src >= 0) & (src < size)
            m[2 * k[ok] + d, src[ok]] += table[d, t, ok].to(torch.float64)
    return m


def _up2_plain(q, rnum, cnum, inv):
    """Align-corners x2 of int8 q (N,h,w,C) in integer-exact float64 sums,
    then one float32 multiply by inv, round, clip (``up2_mxu_reference``)."""
    t = torch.einsum("ok,nkwc->nowc", _mix_matrix(rnum), q.to(torch.float64))
    y = torch.einsum("pl,nolc->nopc", _mix_matrix(cnum), t)
    return requant(y.to(torch.float32) * float(inv), False)


def _up2_vpu_plain(q, rc, cc, inv):
    """The float32 chain of ``up2_impl='vpu'`` on int8 q (N,h,w,C): row
    pass, column pass (``resize_phases.phase_passes``: same taps, order and
    roundings), one multiply by inv, round, clip."""
    y = phase_passes(q.to(torch.float32), (-1, 0, 1), rc, cc)
    return requant(y * float(inv), False)


def conv_prow_up2_plain(x, w, scale, bias, rnum, cnum, inv, relu=True):
    """Integer tables (``up2_coeffs_mxu``) take the integer-exact chain,
    float32 tables (``up2_coeffs``) the float32 one."""
    q = conv_prow_plain(x, w, scale, bias, relu)
    if rnum.dtype == torch.float32:
        return _up2_vpu_plain(q, rnum, cnum, inv)
    return _up2_plain(q, rnum, cnum, inv)


conv_prow_up2_pack_plain = conv_prow_up2_plain
conv_prow_dual_planes_plain = conv_i8_exact_dual_plain
conv_prow_dual_plain = conv_i8_exact_dual_plain


# ----------------------------------------------------------------- launches

@functools.lru_cache(maxsize=None)
def _lib():
    return bind(_build.load("conv_px"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of ``csrc/conv_px.cu`` on a loaded library:
    the built one, or one built from a variant of the source
    (``kernels/tc_variants.py``)."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sifsr_error_string.argtypes = [i]
    lib.sifsr_error_string.restype = ctypes.c_char_p
    sigs = {
        "sifsr_conv_prow": [vp, vp, vp, vp, vp, f, vp, i, i, i, i, i, i, vp],
        "sifsr_conv_prow_split_pool": [vp, vp, vp, vp, vp, vp, f, i, i, i, i, i, i, vp],
        "sifsr_conv_prow_up2": [vp, vp, vp, vp, vp, vp, f, vp, i, i, i, i, i, i, vp],
        "sifsr_conv_prow_up2_vpu": [vp, vp, vp, vp, vp, vp, f, vp, i, i, i, i, i, i, vp],
        "sifsr_conv_prow_dual": [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp],
        "sifsr_conv_mma_shape": [i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i),
                                 ctypes.POINTER(i)],
    }
    for name, args in sigs.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


_MMA_KINDS = {"dual": 0, "up2": 1, "up2_vpu": 2, "prow": 3, "prow_res": 4, "pool": 5}
# the entries of csrc/conv_i8.cu, each at one channel pair: kind -> (index, cin, cout)
_MMA_I8_KINDS = {"exact": (0, 16, 16), "exact_pm": (1, 16, 16), "exact_dual": (2, 16, 16),
                 "in1_split": (3, 2, 16), "in1": (4, 2, 16), "outlay": (5, 16, 1)}


def tensor_core_launch(kind: str, n: int, h: int, w: int, cin: int, cout: int) -> dict:
    """The launch the tensor-core entry ``kind`` ('dual': J and L, 'up2': I
    and K, 'up2_vpu': their float32 chain, 'prow' and 'prow_res': G without
    and with the residual, 'pool': H; 'exact', 'exact_pm': B without and
    with the phase mean, 'exact_dual': C, at 16 channels; 'in1_split': D and
    'in1': E at 2 -> 16; 'outlay': F and the generic conv at 16 -> 1) makes
    for an (n,h,w,cin) input: {'blocks': persistent grid, 'smem_bytes':
    dynamic shared memory a block, 'tiles': output tiles the blocks walk}.
    Needs the card."""
    out = [ctypes.c_int(0) for _ in range(3)]
    refs = [ctypes.byref(v) for v in out]
    if kind in _MMA_I8_KINDS:
        index, kin, kout = _MMA_I8_KINDS[kind]
        if (cin, cout) != (kin, kout):
            raise ValueError(f"{kind} takes {kin} -> {kout} channels, got {cin} -> {cout}")
        lib = _conv_i8_lib()
        code = lib.sifsr_conv_i8_mma_shape(index, n, h, w, *refs)
    else:
        lib = _lib()
        code = lib.sifsr_conv_mma_shape(_MMA_KINDS[kind], cin, cout, n, h, w, *refs)
    _build.check(lib, code, f"tensor_core_launch({kind})")
    return dict(zip(("blocks", "smem_bytes", "tiles"), (v.value for v in out)))


def _nonempty(n, h, wd, what):
    if min(n, h, wd) < 1:
        raise ValueError(f"{what} takes N, H, W >= 1, got {n}x{h}x{wd}")


def _conv_checks(x, w, scale, bias, shapes, what):
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if (cin, cout) not in shapes:
        raise ValueError(f"{what} is not built for {cin} -> {cout} channels")
    dev = x.device
    _check(x, "x", (n, h, wd, cin), torch.int8, dev)
    _check(w, "w", (3, 3, cin, cout), torch.int8, dev)
    _check(scale, "scale", (cout,), torch.float32, dev)
    _check(bias, "bias", (cout,), torch.float32, dev)
    return n, h, wd, cin, cout


def conv_prow(x, w, scale, bias, relu: bool = True, residual=None, res_sc: float | None = None):
    """Kernel G. x (N,H,W,C) int8, w HWIO (3,3,C,C) int8, scale/bias (C,)
    float32 -> (N,H,W,C) int8 requant(relu(acc*scale + bias)); with
    ``residual`` (N,H,W,C) int8, requant(residual*res_sc + relu(...))."""
    if (residual is None) != (res_sc is None):
        raise ValueError("residual and res_sc go together")
    if not _device(x):
        return conv_prow_plain(x, w, scale, bias, relu, residual, res_sc)
    n, h, wd, cin, cout = _conv_checks(x, w, scale, bias, PROW_SHAPES, "conv_prow")
    if residual is not None:
        _check(residual, "residual", (n, h, wd, cout), torch.int8, x.device)
    out = torch.empty((n, h, wd, cout), dtype=torch.int8, device=x.device)
    lib = _lib()
    code = lib.sifsr_conv_prow(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        0.0 if res_sc is None else res_sc, out.data_ptr(), n, h, wd, cin, cout, int(relu),
        _stream(x))
    _build.check(lib, code, "conv_prow")
    conv_prow.launches += 1
    return out


def conv_prow_split_pool(x, w, scale, bias, pool_sc: float, relu: bool = True):
    """Kernel H. x (N,H,W,Cin) int8 -> (skip (N,H,W,Cout) int8
    requant(relu(acc*scale + bias)), pooled (N,H/2,W/2,Cout) int8
    requant(int32 2x2 sum of skip * pool_sc)); pool_sc is float32
    s_out / (4 * s_next)."""
    if not _device(x):
        return conv_prow_split_pool_plain(x, w, scale, bias, pool_sc, relu)
    n, h, wd, cin, cout = _conv_checks(x, w, scale, bias, POOL_SHAPES, "conv_prow_split_pool")
    if h % 2 or wd % 2:
        raise ValueError(f"the 2x2 pool needs even H, W, got {h}x{wd}")
    out = torch.empty((n, h, wd, cout), dtype=torch.int8, device=x.device)
    pool = torch.empty((n, h // 2, wd // 2, cout), dtype=torch.int8, device=x.device)
    lib = _lib()
    code = lib.sifsr_conv_prow_split_pool(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        pool.data_ptr(), pool_sc, n, h, wd, cin, cout, int(relu), _stream(x))
    _build.check(lib, code, "conv_prow_split_pool")
    conv_prow_split_pool.launches += 1
    return out, pool


def _up2_launch(x, w, scale, bias, rnum, cnum, inv, relu, shapes, what):
    n, h, wd, cin, cout = _conv_checks(x, w, scale, bias, shapes, what)
    if rnum.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{what}: the x2 tables must be int32 (up2_coeffs_mxu) or float32 "
                         f"(up2_coeffs), got {rnum.dtype}")
    _check(rnum, "rnum", (2, 3, h), rnum.dtype, x.device)
    _check(cnum, "cnum", (2, 3, wd), rnum.dtype, x.device)
    _nonempty(n, h, wd, what)
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=torch.int8, device=x.device)
    lib = _lib()
    entry = lib.sifsr_conv_prow_up2 if rnum.dtype == torch.int32 else lib.sifsr_conv_prow_up2_vpu
    code = entry(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), rnum.data_ptr(),
        cnum.data_ptr(), float(inv), out.data_ptr(), n, h, wd, cin, cout, int(relu),
        _stream(x))
    _build.check(lib, code, what)
    return out


def conv_prow_up2(x, w, scale, bias, rnum, cnum, inv, relu: bool = True):
    """Kernel I. x (N,H,W,Cin) int8 -> (N,2H,2W,Cout) int8: the conv
    requantised at the mid scale, then the align-corners x2 with the
    numerators rnum (2,3,H) / cnum (2,3,W) int32 and float32 ``inv`` of
    ``up2_coeffs_mxu``, or with the float32 tables rc / cc and ``inv`` of
    ``up2_coeffs`` in their place (the ``up2_impl='vpu'`` chain)."""
    if not _device(x):
        return conv_prow_up2_plain(x, w, scale, bias, rnum, cnum, inv, relu)
    out = _up2_launch(x, w, scale, bias, rnum, cnum, inv, relu, UP2_SHAPES, "conv_prow_up2")
    conv_prow_up2.launches += 1
    return out


def conv_prow_up2_pack(x, w, scale, bias, rnum, cnum, inv, relu: bool = True):
    """Kernel K: I's function for ub2.conv2 (32 -> 16 at 128²), the serving
    tail whose (N,256,256,16) output at the ``up`` scale feeds kernel C
    (the TPU kernel also packs it to pair rows, a layout)."""
    if not _device(x):
        return conv_prow_up2_pack_plain(x, w, scale, bias, rnum, cnum, inv, relu)
    out = _up2_launch(x, w, scale, bias, rnum, cnum, inv, relu, UP2_PACK_SHAPES,
                      "conv_prow_up2_pack")
    conv_prow_up2_pack.launches += 1
    return out


def _dual_launch(x, z, wx, wz, scale_x, scale_z, bias, relu, what):
    n, h, wd, c = x.shape
    if c not in DUAL_CHANNELS:
        raise ValueError(f"{what} is not built for {c} channels")
    dev = x.device
    for name, t in (("x", x), ("z", z)):
        _check(t, name, (n, h, wd, c), torch.int8, dev)
    for name, t in (("wx", wx), ("wz", wz)):
        _check(t, name, (3, 3, c, c), torch.int8, dev)
    for name, t in (("scale_x", scale_x), ("scale_z", scale_z), ("bias", bias)):
        _check(t, name, (c,), torch.float32, dev)
    _nonempty(n, h, wd, what)
    out = torch.empty_like(x)
    lib = _lib()
    code = lib.sifsr_conv_prow_dual(
        x.data_ptr(), z.data_ptr(), wx.data_ptr(), wz.data_ptr(), scale_x.data_ptr(),
        scale_z.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, wd, c, int(relu),
        _stream(x))
    _build.check(lib, code, what)
    return out


def conv_prow_dual_planes(x, z, wx, wz, scale_x, scale_z, bias, relu: bool = True):
    """Kernel J. x, z (N,H,W,C) int8, C 32 or 64 -> (N,H,W,C) int8
    requant(relu(conv(x, wx)*scale_x + conv(z, wz)*scale_z + bias)); z is
    the skip, H's full-resolution output."""
    if not _device(x):
        return conv_prow_dual_planes_plain(x, z, wx, wz, scale_x, scale_z, bias, relu)
    out = _dual_launch(x, z, wx, wz, scale_x, scale_z, bias, relu, "conv_prow_dual_planes")
    conv_prow_dual_planes.launches += 1
    return out


def conv_prow_dual(x, z, wx, wz, scale_x, scale_z, bias, relu: bool = True):
    """Kernel L: J's function with the skip as one tensor (which it is in
    NHWC), through J's entry point; same arguments and result as J."""
    if not _device(x):
        return conv_prow_dual_plain(x, z, wx, wz, scale_x, scale_z, bias, relu)
    out = _dual_launch(x, z, wx, wz, scale_x, scale_z, bias, relu, "conv_prow_dual")
    conv_prow_dual.launches += 1
    return out


for _k in (conv_prow, conv_prow_split_pool, conv_prow_up2, conv_prow_dual_planes,
           conv_prow_up2_pack, conv_prow_dual):
    _k.launches = 0
