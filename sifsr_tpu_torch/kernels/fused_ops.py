"""Kernels M and N: the fused sensor-model ops of the training losses.

Counterparts of ``sifsr_tpu/pallas/fused_ops.py``; CUDA source
``csrc/fused_ops.cu``.

``fused_psf_downscale`` (kernel M) is the ds-loss degradation, per image:
un-normalise -> ``M @ X @ Mᵀ`` (the collapsed pad/PSF/bicubic/crop matrix of
``ops.psf.downscale_matrix``) -> re-normalise. The two affine normalisations
fold into a constant surface,

    renorm(M @ unnorm(X) @ Mᵀ) = M X Mᵀ + mean·(rowsum(M)·rowsum(M)ᵀ - 1)/std

so the kernel computes the two products and adds the constant in one pass.
The op is linear in X, so its gradient is the transposed sandwich
``Mᵀ g M``: ``fused_psf_downscale`` is a ``torch.autograd.Function`` whose
backward launches the same kernel with ``Mᵀ`` and no constant. The kernel
takes its matrix as a band (``_band``: each row's first column and a fixed
number of coefficients from there), since a row of ``M`` holds at most
``2·factor + 4`` nonzeros in one run and a row of ``Mᵀ`` at most 4.

``fused_norm_l4`` (kernel N) fuses un-normalise -> x⁴ block mean -> ⁴√ ->
optional re-normalise. No path of the JAX package calls its kernel; here
``data.datasets.degrade_batch_scale_invariance`` does (the 1 km -> 4 km LST
of the scale-invariance recipe is exactly this function).

Tolerances against the plain versions evaluated in float64 (float kernels
sum in another order than any reference, so they cannot be held to
"identical" as the int8 kernels are): kernel M forward and backward
max|d| <= 1e-5 on N(0, 1) inputs; kernel N relative 1e-6, measured on the
un-normalised value when ``renorm`` is set.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from sifsr_tpu_torch.kernels import _build
from sifsr_tpu_torch.ops.pooling import norm_l4_downsample
from sifsr_tpu_torch.ops.psf import downscale_lst_sr_to_lr, downscale_matrix

__all__ = ["fused_psf_downscale", "fused_psf_downscale_plain", "fused_norm_l4",
           "fused_norm_l4_plain"]


@functools.lru_cache(maxsize=32)
def _matrix(in_size: int, factor: int, mtf: float) -> np.ndarray:
    """M in float64 (``ops.psf.downscale_matrix``): the one source of the
    kernel's bands, its constant and the dense float32 M."""
    return downscale_matrix(in_size, factor, mtf, None, "bic", True)


@functools.lru_cache(maxsize=32)
def _renorm_constant(in_size: int, factor: int, mtf: float, mean_lst: float, std_lst: float,
                     device: torch.device) -> torch.Tensor:
    """The forward's constant as a float32 tensor on ``device``, formed in
    float64 and then cast, as ``sifsr_tpu/pallas/fused_ops.py:66-69``."""
    row = _matrix(in_size, factor, mtf).sum(axis=1)
    const = (mean_lst * (np.outer(row, row) - 1.0) / std_lst).astype(np.float32)
    return torch.as_tensor(const, device=device)


def _sandwich_constants(in_size: int, factor: int, mtf: float, mean_lst: float,
                        std_lst: float, device: torch.device):
    """(M, Mᵀ, const) as float32 tensors on ``device``: the dense operands of
    the PyTorch chain that computes what the kernel does (two matmuls and
    an add)."""
    m = torch.as_tensor(_matrix(in_size, factor, mtf), dtype=torch.float32, device=device)
    return m, m.T.contiguous(), _renorm_constant(in_size, factor, mtf, mean_lst, std_lst, device)


# shared memory a block (csrc/fused_ops.cu takes a band of any width)
_SMEM_BYTES = 227 * 1024
# output rows a block takes where they fit: forward (M's band), backward (Mᵀ's)
_BLOCK_ROWS = (8, 32)


def _pitch(cols: int) -> int:
    """A row of ``cols`` floats in shared memory, rounded up to 4 floats."""
    return -(-cols // 4) * 4


def _stage_bytes(rows: int, width: int, cols: int, span: int, chunk: int) -> int:
    """Shared memory of a block as csrc/fused_ops.cu lays it out: the tile's
    band (rows x width coefficients and rows starts, padded to 16 bytes), T
    (rows x cols, column j at j + j/32) and ``span`` staged rows of X,
    ``chunk`` columns at a time."""
    return 4 * (_pitch(rows * (width + 1)) + rows * _pitch(_pitch(cols) + _pitch(cols) // 32)
                + span * _pitch(min(chunk, cols)))


def _tiling(lo: np.ndarray, width: int, cols: int, rows: int):
    """(rows, chunk, tile_in, span) of a band's launch, the one rule: ``rows``
    output rows a block, halved while T and a 4-column stage of the rows of
    X the tile covers would not fit in the 227 KB of shared memory a block;
    then the fewest even chunks of columns (multiples of 4) whose staged
    rows fit beside T (one chunk, all ``cols``, where they do). Tile t
    covers the input rows ``tile_in[t, 0]`` to ``tile_in[t, 1]``, at most
    ``span`` of them. A shape that fits no way keeps one row and chunks of
    4 columns, and ``_band_refusal`` refuses it."""
    while True:
        tile_in = np.array([(lo[r:r + rows].min(), lo[r:r + rows].max() + width)
                            for r in range(0, len(lo), rows)], np.int32)
        span = int((tile_in[:, 1] - tile_in[:, 0]).max())
        room = (_SMEM_BYTES - _stage_bytes(rows, width, cols, 0, cols)) // (16 * span) * 4
        if room >= 4 or rows == 1:
            break
        rows //= 2
    chunks = -(-cols // max(room, 4))
    return rows, _pitch(-(-cols // chunks)), tile_in, span


def _band(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo, coef) of a float32 matrix (rows, cols) whose nonzeros form one
    contiguous run in every row: row r is ``coef[r]`` (``width`` values, the
    longest run) from column ``lo[r]``, zeros elsewhere. Where a run ends
    within ``width`` of the last column, lo moves left and the row's
    coefficients start with zeros, so that ``lo + width <= cols`` always."""
    a = np.asarray(a, np.float32)
    rows, cols = a.shape
    first, last = np.zeros(rows, np.int64), np.zeros(rows, np.int64)
    for r in range(rows):
        nz = np.flatnonzero(a[r])
        if nz.size and nz.size != nz[-1] - nz[0] + 1:
            raise ValueError(f"row {r}: its nonzeros are not one contiguous run")
        if nz.size:
            first[r], last[r] = nz[0], nz[-1]
    width = int((last - first).max()) + 1
    lo = np.minimum(first, cols - width).astype(np.int32)
    coef = np.stack([a[r, lo[r]:lo[r] + width] for r in range(rows)]).astype(np.float32)
    return lo, coef


class _Band(NamedTuple):
    """A band on the device with the tiling it is launched at (``_tiling``):
    a block takes ``rows`` output rows, tile t the input rows
    ``tile_in[t, 0]`` to ``tile_in[t, 1]`` (a host array the launch passes
    by value), at most ``span`` of them, staged ``chunk`` columns at a
    time."""

    lo: torch.Tensor       # (rows of A,) int32
    coef: torch.Tensor     # (rows of A, width) float32
    tile_in: np.ndarray    # (tiles, 2) int32
    rows: int
    span: int
    chunk: int


@functools.lru_cache(maxsize=32)
def _sandwich_bands(in_size: int, factor: int, mtf: float,
                    device: torch.device) -> tuple[_Band, _Band]:
    """The bands of M (the forward's matrix) and of Mᵀ (the backward's), read
    off the float32 M, each with its launch's tiling (``_tiling``, from
    ``_BLOCK_ROWS`` output rows a block)."""
    m = _matrix(in_size, factor, mtf).astype(np.float32)
    bands = []
    for a, rows in ((m, _BLOCK_ROWS[0]), (m.T, _BLOCK_ROWS[1])):
        lo, coef = _band(a)
        rows, chunk, tile_in, span = _tiling(lo, coef.shape[1], a.shape[1], rows)
        bands.append(_Band(torch.as_tensor(lo, device=device),
                           torch.as_tensor(coef, device=device), tile_in, rows, span, chunk))
    return bands[0], bands[1]


def _band_refusal(size: int, band: _Band) -> str | None:
    """Why the kernel would refuse ``band`` on a (size, size) input, or None:
    a tiling whose block needs more shared memory than the card has."""
    smem = _stage_bytes(band.rows, band.coef.shape[1], size, band.span, band.chunk)
    if smem > _SMEM_BYTES:
        return (f"{size}x{size} in tiles of {band.rows} rows and chunks of {band.chunk} "
                f"columns, {smem} bytes of shared memory a block; the kernel takes at most "
                f"{_SMEM_BYTES} bytes")
    return None


def _check_band(size: int, band: _Band) -> None:
    """Raise ValueError where the kernel would refuse ``band`` on a
    (size, size) input (``_band_refusal``)."""
    why = _band_refusal(size, band)
    if why is not None:
        raise ValueError(why)


@functools.lru_cache(maxsize=32)
def _shape_refusal(size: int, factor: int, mtf: float) -> str | None:
    """Why kernel M does not take a (size, size) input at this factor and
    mtf, or None: M or Mᵀ has no band, or the kernel refuses one of them.
    Decided on the host, for both directions, before any launch. The kernel
    takes a band of any width (factor 128 at 256²: 194 coefficients); no
    shape of the recipes comes near the shared memory's end."""
    try:
        band_m, band_mt = _sandwich_bands(size, factor, mtf, torch.device("cpu"))
    except ValueError as e:   # a row of M or Mᵀ whose nonzeros are not one run
        return str(e)
    return _band_refusal(size, band_m) or _band_refusal(size // factor, band_mt)


def fused_psf_downscale_plain(x: torch.Tensor, mean_lst: float, std_lst: float,
                              factor: int = 4, mtf: float = 0.1) -> torch.Tensor:
    """The plain PyTorch version, in x's dtype: the matmul chain
    ``(downscale(x*std + mean) - mean) / std`` with autograd's own gradient."""
    down = downscale_lst_sr_to_lr(x * std_lst + mean_lst, factor=factor, mtf=mtf)
    return (down - mean_lst) / std_lst


def _sandwich(x: torch.Tensor, band: _Band, const: torch.Tensor | None) -> torch.Tensor:
    """Launch ``A @ x[i] @ Aᵀ + const`` for a contiguous CUDA float32
    (n, in, in) batch, A given as its band; the device and the current
    stream are taken here, at the call, since autograd runs a backward on a
    thread of its own."""
    n, size, _ = x.shape
    _check_band(size, band)
    out, width = band.coef.shape
    y = torch.empty((n, out, out), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.sifsr_sandwich(x.data_ptr(), band.lo.data_ptr(), band.coef.data_ptr(),
                                  band.tile_in.ctypes.data,
                                  None if const is None else const.data_ptr(),
                                  y.data_ptr(), n, size, out, width, band.rows, band.span,
                                  band.chunk, stream)
    _build.check(lib, code, "fused_psf_downscale")
    return y


class _FusedPsfDownscale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean_lst, std_lst, factor, mtf):
        const = _renorm_constant(x.shape[-1], factor, mtf, mean_lst, std_lst, x.device)
        band_m, ctx.band_mt = _sandwich_bands(x.shape[-1], factor, mtf, x.device)
        y = _sandwich(x.contiguous(), band_m, const)
        fused_psf_downscale.launches += 1
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # the incoming gradient may be an expanded or strided view
        dx = _sandwich(g.contiguous(), ctx.band_mt, None)
        fused_psf_downscale.backward_launches += 1
        return dx, None, None, None, None


def _on_card(x: torch.Tensor, mean_lst: float, std_lst: float, factor: int,
             mtf: float) -> torch.Tensor:
    """The route of a CUDA tensor: the kernel forward and backward, or
    ValueError before any launch where it does not take the shape
    (``_shape_refusal``)."""
    why = _shape_refusal(x.shape[-1], factor, mtf)
    if why is not None:
        raise ValueError(f"fused_psf_downscale at {x.shape[-1]}² and factor {factor}: {why}")
    return _FusedPsfDownscale.apply(x, mean_lst, std_lst, factor, mtf)


def fused_psf_downscale(x: torch.Tensor, mean_lst: float, std_lst: float,
                        factor: int = 4, mtf: float = 0.1) -> torch.Tensor:
    """renorm(downscale(unnorm(x))) for a normalised (N, H, H) float32 batch
    -> (N, H/factor, H/factor), differentiable in x.

    On a CUDA tensor the forward and the backward each launch the kernel
    (``.launches`` and ``.backward_launches`` count them); on a CPU tensor
    the plain version runs."""
    if x.dim() != 3 or x.shape[-1] != x.shape[-2] or x.dtype != torch.float32:
        raise ValueError(f"expected (N, H, H) float32, got {tuple(x.shape)} {x.dtype}")
    mean_lst, std_lst = float(mean_lst), float(std_lst)
    if x.device.type == "cpu":
        return fused_psf_downscale_plain(x, mean_lst, std_lst, factor, mtf)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _on_card(x, mean_lst, std_lst, factor, mtf)


fused_psf_downscale.launches = 0
fused_psf_downscale.backward_launches = 0


def fused_norm_l4_plain(x: torch.Tensor, mean_lst: float = 0.0, std_lst: float = 1.0,
                        factor: int = 4, renorm: bool = False) -> torch.Tensor:
    """The plain PyTorch version, in x's dtype."""
    y = norm_l4_downsample(x * std_lst + mean_lst, factor)
    return (y - mean_lst) / std_lst if renorm else y


def fused_norm_l4(x: torch.Tensor, mean_lst: float = 0.0, std_lst: float = 1.0,
                  factor: int = 4, renorm: bool = False) -> torch.Tensor:
    """Fused unnorm -> norm-L4 pool -> (optional) renorm on an (N, H, W)
    float32 batch -> (N, H/factor, W/factor)."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"expected (N, H, W) float32, got {tuple(x.shape)} {x.dtype}")
    n, h, w = x.shape
    if factor < 1 or h % factor or w % factor:
        raise ValueError(f"{h}x{w} is not a multiple of factor {factor}")
    mean_lst, std_lst = float(mean_lst), float(std_lst)
    if x.device.type == "cpu":
        return fused_norm_l4_plain(x, mean_lst, std_lst, factor, renorm)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    y = torch.empty((n, h // factor, w // factor), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.sifsr_norm_l4(x.data_ptr(), y.data_ptr(), n, h, w, factor, mean_lst,
                                 std_lst, int(renorm), stream)
    _build.check(lib, code, "fused_norm_l4")
    fused_norm_l4.launches += 1
    return y


fused_norm_l4.launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_ops")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sifsr_sandwich.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.sifsr_sandwich.restype = i
    lib.sifsr_norm_l4.argtypes = [vp, vp, i, i, i, i, f, f, i, vp]
    lib.sifsr_norm_l4.restype = i
    return lib
