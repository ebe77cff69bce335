"""Kernels B, C, D and the generic int8 conv: replicate-pad 3x3 int8 convs.

Counterparts, CUDA source ``csrc/conv_i8.cu``:

- ``conv_i8_exact`` (B): ``sifsr_tpu/pallas/conv_i8.py::conv_i8_exact``,
  16 -> 16 with the optional fused phase mean (inbloc.conv2, ub3.conv2);
- ``conv_i8_exact_dual`` (C): ``conv_i8.py::conv_i8_exact_dual``,
  conv(concat(x, z)) as two convs with their own scales (ub3.conv1);
- ``conv_i8_in1_split`` (D): ``conv_i8.py::conv_i8_in1_split``, 2 -> 16 with
  LST and NDVI as separate inputs (inbloc.conv1);
- ``conv_i8_generic``: the XLA int8 conv of
  ``sifsr_tpu/models/quantized_packed.py::_conv_i8_generic`` (mid chain) and
  the outlay conv of ``pallas_serving.py:494-524``, float32 output.

The TPU kernels run in the 2x2 space-to-depth packed domain as pixel-pair
rows; these take the unpacked NHWC int8 tensors the packed ones stand for
(the packed replicate-pad conv equals the unpacked one). Every wrapper
checks device, dtype, shape and contiguity, launches on the current stream
and raises on a launch error; it runs the plain version (int8 values summed
exactly in float64, then the same float32 epilogue) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sifsr_tpu_torch.kernels import _build

__all__ = [
    "conv_i8_exact", "conv_i8_exact_dual", "conv_i8_in1_split", "conv_i8_generic",
    "conv_i8_exact_plain", "conv_i8_exact_dual_plain", "conv_i8_in1_split_plain",
    "conv_i8_generic_plain",
]


# ------------------------------------------------------------ plain versions

def conv3x3_i32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact replicate-pad 3x3 conv of int8 values: (N,H,W,C) x HWIO (3,3,C,K)
    -> int32 (N,H,W,K). Sums in float64 (exact below 2^53) tap by tap."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (1, 1, 1, 1), mode="replicate")
    wf = w.to(torch.float64)
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("nchw,ck->nhwk", xp[:, :, dy:dy + h, dx:dx + wd], wf[dy, dx])
            acc = t if acc is None else acc + t
    return acc.to(torch.int32)


def requant(y: torch.Tensor, relu: bool) -> torch.Tensor:
    """[ReLU] -> round half-to-even -> clip [-127, 127] -> int8."""
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def _dequant(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.float32) * scale + bias


def _phase_mean(q: torch.Tensor, pm_scale: float) -> torch.Tensor:
    n, h, w, c = q.shape
    s4 = q.to(torch.int32).reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))
    return requant(s4.to(torch.float32) * pm_scale, False)


def conv_i8_exact_plain(x, w, scale, bias, relu=True, pm_scale=None):
    y = requant(_dequant(conv3x3_i32(x, w), scale, bias), relu)
    return y if pm_scale is None else (y, _phase_mean(y, pm_scale))


def conv_i8_exact_dual_plain(x, z, wx, wz, scale_x, scale_z, bias, relu=True):
    yx = conv3x3_i32(x, wx).to(torch.float32) * scale_x
    yz = conv3x3_i32(z, wz).to(torch.float32) * scale_z
    return requant(yx + yz + bias, relu)


def conv_i8_in1_split_plain(lst, ndvi, w, scale, bias, relu=True):
    x = torch.stack([lst, ndvi], dim=-1)
    return requant(_dequant(conv3x3_i32(x, w), scale, bias), relu)


def conv_i8_generic_plain(x, w, scale, bias, relu=True):
    y = _dequant(conv3x3_i32(x, w), scale, bias)
    return torch.clamp_min(y, 0.0) if relu else y


# ----------------------------------------------------------------- launches

def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _device(x: torch.Tensor) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_i8")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "sifsr_conv_i8_exact": [vp, vp, vp, vp, vp, vp, f, i, i, i, i, vp],
        "sifsr_conv_i8_exact_dual": [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp],
        "sifsr_conv_i8_in1_split": [vp, vp, vp, vp, vp, vp, i, i, i, i, vp],
        "sifsr_conv_i8_generic": [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp],
        "sifsr_conv_i8_generic_supported": [i, i],
    }
    for name, args in sigs.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def conv_i8_exact(x, w, scale, bias, relu: bool = True, pm_scale: float | None = None):
    """Kernel B. x (N,H,W,16) int8, w HWIO (3,3,16,16) int8, scale/bias (16,)
    float32 -> (N,H,W,16) int8 requant(acc*scale + bias). With ``pm_scale``
    (float32 phase_mean/4) also returns the phase mean (N,H/2,W/2,16) int8,
    rint(2x2 int sum of the output * pm_scale) clipped."""
    if not _device(x):
        return conv_i8_exact_plain(x, w, scale, bias, relu, pm_scale)
    n, h, wd, _ = x.shape
    dev = x.device
    _check(x, "x", (n, h, wd, 16), torch.int8, dev)
    _check(w, "w", (3, 3, 16, 16), torch.int8, dev)
    _check(scale, "scale", (16,), torch.float32, dev)
    _check(bias, "bias", (16,), torch.float32, dev)
    out = torch.empty_like(x)
    pm = None
    if pm_scale is not None:
        if h % 2 or wd % 2:
            raise ValueError(f"phase mean needs even H, W, got {h}x{wd}")
        pm = torch.empty((n, h // 2, wd // 2, 16), dtype=torch.int8, device=dev)
    lib = _lib()
    code = lib.sifsr_conv_i8_exact(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        None if pm is None else pm.data_ptr(), 0.0 if pm_scale is None else pm_scale,
        n, h, wd, int(relu), _stream(x))
    _build.check(lib, code, "conv_i8_exact")
    conv_i8_exact.launches += 1
    return out if pm is None else (out, pm)


def conv_i8_exact_dual(x, z, wx, wz, scale_x, scale_z, bias, relu: bool = True):
    """Kernel C. x, z (N,H,W,16) int8 -> (N,H,W,16) int8
    requant(conv(x, wx)*scale_x + conv(z, wz)*scale_z + bias)."""
    if not _device(x):
        return conv_i8_exact_dual_plain(x, z, wx, wz, scale_x, scale_z, bias, relu)
    n, h, wd, _ = x.shape
    dev = x.device
    for name, t in (("x", x), ("z", z)):
        _check(t, name, (n, h, wd, 16), torch.int8, dev)
    for name, t in (("wx", wx), ("wz", wz)):
        _check(t, name, (3, 3, 16, 16), torch.int8, dev)
    for name, t in (("scale_x", scale_x), ("scale_z", scale_z), ("bias", bias)):
        _check(t, name, (16,), torch.float32, dev)
    out = torch.empty_like(x)
    lib = _lib()
    code = lib.sifsr_conv_i8_exact_dual(
        x.data_ptr(), z.data_ptr(), wx.data_ptr(), wz.data_ptr(), scale_x.data_ptr(),
        scale_z.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, wd, int(relu), _stream(x))
    _build.check(lib, code, "conv_i8_exact_dual")
    conv_i8_exact_dual.launches += 1
    return out


def conv_i8_in1_split(lst, ndvi, w, scale, bias, relu: bool = True):
    """Kernel D. lst, ndvi (N,H,W) int8, w HWIO (3,3,2,16) int8 (input channel
    0 = LST, 1 = NDVI) -> (N,H,W,16) int8."""
    if not _device(lst):
        return conv_i8_in1_split_plain(lst, ndvi, w, scale, bias, relu)
    n, h, wd = lst.shape
    dev = lst.device
    for name, t in (("lst", lst), ("ndvi", ndvi)):
        _check(t, name, (n, h, wd), torch.int8, dev)
    _check(w, "w", (3, 3, 2, 16), torch.int8, dev)
    _check(scale, "scale", (16,), torch.float32, dev)
    _check(bias, "bias", (16,), torch.float32, dev)
    out = torch.empty((n, h, wd, 16), dtype=torch.int8, device=dev)
    lib = _lib()
    code = lib.sifsr_conv_i8_in1_split(
        lst.data_ptr(), ndvi.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, wd, int(relu), _stream(lst))
    _build.check(lib, code, "conv_i8_in1_split")
    conv_i8_in1_split.launches += 1
    return out


def conv_i8_generic(x, w, scale, bias, relu: bool = True):
    """x (N,H,W,Cin) int8, w HWIO (3,3,Cin,Cout) int8, scale/bias (Cout,)
    float32 -> (N,H,W,Cout) float32 acc*scale + bias [ReLU]. The kernel is
    built for the (Cin, Cout) pairs of ModelB2's mid chain and outlay."""
    if not _device(x):
        return conv_i8_generic_plain(x, w, scale, bias, relu)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    dev = x.device
    lib = _lib()
    if not lib.sifsr_conv_i8_generic_supported(cin, cout):
        raise ValueError(f"conv_i8_generic is not built for {cin} -> {cout} channels")
    _check(x, "x", (n, h, wd, cin), torch.int8, dev)
    _check(w, "w", (3, 3, cin, cout), torch.int8, dev)
    _check(scale, "scale", (cout,), torch.float32, dev)
    _check(bias, "bias", (cout,), torch.float32, dev)
    out = torch.empty((n, h, wd, cout), dtype=torch.float32, device=dev)
    code = lib.sifsr_conv_i8_generic(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, h, wd, cin, cout, int(relu), _stream(x))
    _build.check(lib, code, "conv_i8_generic")
    conv_i8_generic.launches += 1
    return out


for _k in (conv_i8_exact, conv_i8_exact_dual, conv_i8_in1_split, conv_i8_generic):
    _k.launches = 0
