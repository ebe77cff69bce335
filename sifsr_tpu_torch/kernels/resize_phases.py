"""Kernel A: phase-separated integer-factor upsample, optional int8 epilogue.

Counterpart of ``sifsr_tpu/pallas/resize_phases.py::upsample_phases``; CUDA
source ``csrc/resize_phases.cu``. The serving step runs it twice per batch:
the cv2-exact cubic x4 of the normalised LST (quantised to the inbloc.conv1
input scale) and the align-corners bilinear x2 feeding ub3 (quantised to the
``up`` scale).

The TPU kernel emits phase-separated planes (N, f, f, H, W, C) because the
row/column interleave is a lane crossing Mosaic cannot express; this port
returns the upsampled NHWC image directly:
``out[n, f*k + d, f*l + e] == phases[n, d, e, k, l]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sifsr_tpu_torch.kernels import _build
from sifsr_tpu_torch.ops.resize import _upsample_stencil

__all__ = ["upsample_phases", "upsample_phases_plain"]


def _coeff_arrays(size: int, factor: int, kind: str):
    """(deltas, float32 coefficients (factor, n_deltas, size)), as
    ``resize_phases._coeff_arrays`` builds them from the float64 stencil."""
    st = _upsample_stencil(size, factor, kind)
    deltas = tuple(sorted({d for (_, d) in st}))
    out = np.zeros((factor, len(deltas), size), np.float32)
    for (ph, d), coef in st.items():
        out[ph, deltas.index(d)] = coef
    return deltas, out


@functools.lru_cache(maxsize=None)
def _tables(h: int, w: int, factor: int, kind: str):
    """Row and column tables over the union of both axes' ascending deltas.
    A coefficient is exactly 0 wherever its tap leaves the image, so the
    kernel may skip zero coefficients."""
    rdeltas, rcoef = _coeff_arrays(h, factor, kind)
    cdeltas, ccoef = _coeff_arrays(w, factor, kind)
    deltas = tuple(sorted(set(rdeltas) | set(cdeltas)))

    def expand(coeff, have, size):
        full = np.zeros((factor, len(deltas), size), np.float32)
        for j, d in enumerate(have):
            full[:, deltas.index(d)] = coeff[:, j]
        for j, d in enumerate(deltas):
            pos = np.arange(size) + d
            if np.any(full[:, j, (pos < 0) | (pos >= size)]):
                raise AssertionError(f"out-of-range tap {d} with a nonzero coefficient")
        return full

    return deltas, expand(rcoef, rdeltas, h), expand(ccoef, cdeltas, w)


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, w: int, factor: int, kind: str, device: torch.device):
    deltas, rc, cc = _tables(h, w, factor, kind)
    return deltas, torch.as_tensor(rc, device=device), torch.as_tensor(cc, device=device)


def _inv_scale(scale) -> float:
    """float32 1/scale, the factor the TPU epilogue multiplies by."""
    return float(np.float32(1.0) / np.float32(scale))


def upsample_phases_plain(x: torch.Tensor, factor: int, kind: str, scale=None) -> torch.Tensor:
    """The plain PyTorch version: the same taps, order and roundings."""
    n, h, w, c = x.shape
    deltas, rc, cc = _device_tables(h, w, factor, kind, x.device)
    out = x.new_empty((n, h, factor, w, factor, c))
    for d in range(factor):
        r = None
        for j, dl in enumerate(deltas):
            term = rc[d, j][None, :, None, None] * torch.roll(x, -dl, dims=1)
            r = term if r is None else r + term
        for e in range(factor):
            y = None
            for j, dl in enumerate(deltas):
                term = cc[e, j][None, None, :, None] * torch.roll(r, -dl, dims=2)
                y = term if y is None else y + term
            out[:, :, d, :, e] = y
    y = out.reshape(n, factor * h, factor * w, c)
    if scale is None:
        return y
    return torch.clamp(torch.round(y * _inv_scale(scale)), -127, 127).to(torch.int8)


def upsample_phases(x: torch.Tensor, factor: int, kind: str, scale=None) -> torch.Tensor:
    """(N, H, W, C) float32 -> (N, factor*H, factor*W, C) upsample (``kind``
    'cubic' or 'linear_ac', as ``ops.resize.resize_matrix``).

    scale=None returns float32; a scale returns int8
    clip(round(y * float32(1/scale)), -127, 127) (half-to-even)."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"expected (N, H, W, C) float32, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return upsample_phases_plain(x, factor, kind, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, h, w, c = x.shape
    deltas, rc, cc = _device_tables(h, w, factor, kind, x.device)
    out_int8 = scale is not None
    out = torch.empty((n, factor * h, factor * w, c),
                      dtype=torch.int8 if out_int8 else torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.sifsr_upsample_phases(
        x.data_ptr(), rc.data_ptr(), cc.data_ptr(), (ctypes.c_int * len(deltas))(*deltas),
        len(deltas), factor, n, h, w, c, _inv_scale(scale) if out_int8 else 1.0,
        int(out_int8), out.data_ptr(), stream)
    _build.check(lib, code, "upsample_phases")
    upsample_phases.launches += 1
    return out


upsample_phases.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("resize_phases")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.sifsr_upsample_phases.argtypes = [vp, vp, vp, ctypes.POINTER(i), i, i, i, i, i, i,
                                          ctypes.c_float, i, vp, vp]
    lib.sifsr_upsample_phases.restype = i
    return lib
