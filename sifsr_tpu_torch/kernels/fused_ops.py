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
backward launches the same kernel with ``Mᵀ`` and no constant.

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

import numpy as np
import torch

from sifsr_tpu_torch.kernels import _build
from sifsr_tpu_torch.ops.pooling import norm_l4_downsample
from sifsr_tpu_torch.ops.psf import downscale_lst_sr_to_lr, downscale_matrix

__all__ = ["fused_psf_downscale", "fused_psf_downscale_plain", "fused_norm_l4",
           "fused_norm_l4_plain"]


@functools.lru_cache(maxsize=32)
def _sandwich_constants(in_size: int, factor: int, mtf: float, mean_lst: float,
                        std_lst: float, device: torch.device):
    """(M, Mᵀ, const) as float32 tensors on ``device``, from the float64
    matrix; the constant is formed in float64 and then cast, as
    ``sifsr_tpu/pallas/fused_ops.py:66-69``."""
    m_np = downscale_matrix(in_size, factor, mtf, None, "bic", True)
    row = m_np.sum(axis=1)
    const_np = (mean_lst * (np.outer(row, row) - 1.0) / std_lst).astype(np.float32)
    m = torch.as_tensor(m_np, dtype=torch.float32, device=device)
    return m, m.T.contiguous(), torch.as_tensor(const_np, device=device)


def fused_psf_downscale_plain(x: torch.Tensor, mean_lst: float, std_lst: float,
                              factor: int = 4, mtf: float = 0.1) -> torch.Tensor:
    """The plain PyTorch version, in x's dtype: the matmul chain
    ``(downscale(x*std + mean) - mean) / std`` with autograd's own gradient."""
    down = downscale_lst_sr_to_lr(x * std_lst + mean_lst, factor=factor, mtf=mtf)
    return (down - mean_lst) / std_lst


def _sandwich(x: torch.Tensor, a: torch.Tensor, at: torch.Tensor,
              const: torch.Tensor | None) -> torch.Tensor:
    """Launch ``a @ x[i] @ aᵀ + const`` for a contiguous CUDA float32
    (n, in, in) batch; the device and the current stream are taken here, at
    the call, since autograd runs a backward on a thread of its own."""
    n, size, _ = x.shape
    out = a.shape[0]
    y = torch.empty((n, out, out), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.sifsr_sandwich(x.data_ptr(), a.data_ptr(), at.data_ptr(),
                                  None if const is None else const.data_ptr(),
                                  y.data_ptr(), n, size, out, stream)
    _build.check(lib, code, "fused_psf_downscale")
    return y


class _FusedPsfDownscale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean_lst, std_lst, factor, mtf):
        m, mt, const = _sandwich_constants(x.shape[-1], factor, mtf, mean_lst, std_lst,
                                           x.device)
        ctx.matrices = (m, mt)
        y = _sandwich(x.contiguous(), m, mt, const)
        fused_psf_downscale.launches += 1
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        m, mt = ctx.matrices
        # the incoming gradient may be an expanded or strided view
        dx = _sandwich(g.contiguous(), mt, m, None)
        fused_psf_downscale.backward_launches += 1
        return dx, None, None, None, None


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
    return _FusedPsfDownscale.apply(x, mean_lst, std_lst, factor, mtf)


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
    lib.sifsr_sandwich.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp]
    lib.sifsr_sandwich.restype = i
    lib.sifsr_norm_l4.argtypes = [vp, vp, i, i, i, i, f, f, i, vp]
    lib.sifsr_norm_l4.restype = i
    return lib
