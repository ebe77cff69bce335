"""ModelB_2, the shared-weights SR U-Net, as a PyTorch module.

Port of ``sifsr_tpu/models/unet.py`` (reference model.py:533-645):

    input  (N, 256, 256, 2)  = concat(bicubic-up LST, NDVI), NHWC
    inbloc DoubleConv(2->16)                                   @256² -> skip0
    db1    AvgPool2 -> x + DoubleConv(16->16) -> Conv/BN/ReLU 16->32 @128² -> skip1
    db2    ... 32->64                                          @64²  -> skip2
    db3    ... 64->64 (=128//2, bilinear halves the floor)     @32²
    ub1    bilinear x2 (align_corners) -> cat(x, skip2) -> DoubleConv(128->32, mid 64)
    ub2    -> cat(x, skip1) -> DoubleConv(64->16, mid 32)
    ub3    -> cat(x, skip0) -> DoubleConv(32->16, mid 16)
    outlay Conv3x3(16->1, bias)                                @256²

Submodule names follow the reference torch model, so its state dicts (and
``models.convert.from_jax_variables``) load with ``strict=True``. The
module computes in NCHW; ``forward`` takes and returns NHWC like the JAX
model. BatchNorm is ``nn.BatchNorm2d``, whose semantics the JAX
``TorchBatchNorm`` reproduces, in ``.train()`` mode too (biased variance to
normalise, unbiased for the running update, momentum 0.1). The decoder
upsample is the align-corners matrix of ``ops.resize`` (two matmuls).

Training options: ``dtype=torch.bfloat16`` runs the forward under
``torch.autocast`` (bf16 activations; the parameters, the BatchNorm
statistics and the output stay float32); ``forward(x, remat=True)``
rematerialises block by block; ``precision`` ('highest' or
'default') says whether the train and eval steps keep TF32 off around the
model. ``pad_impl='fused'`` runs each replicate-padded 3x3 conv as a
zero-padded conv plus border-ring corrections (``replicate_conv_fused``),
without the padded copy of its input; it changes only ``forward``, not the
parameters or their names. ``bilinear=False`` is the reference's
ConvTranspose decoder (``ub*.up``: a 2x2 stride-2 transposed conv halving
the channels, then a DoubleConv with mid = out; db3 keeps its full width),
which no published model uses.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sifsr_tpu_torch.ops.resize import upsample_bilinear_x2

__all__ = ["ModelB2", "Conv3x3", "DoubleConv", "DownBlockPool", "UpBlock",
           "replicate_conv_fused"]

DOWNCHANNELS = (16, 32, 64, 128)  # every published ModelB_2 (paramsB.json)


# the four border lines: (edge, dim) = row 0 and row H-1 (dim 2), column 0
# and column W-1 (dim 3); the kernel's outer row or column at the same end
# holds the taps a zero pad drops there
_LINES = ((0, 2), (-1, 2), (0, 3), (-1, 3))
_CORNERS = ((0, 0), (0, -1), (-1, 0), (-1, -1))


def _edge(t: torch.Tensor, end: int, dim: int) -> torch.Tensor:
    """The first (end 0) or last (end -1) slice of ``t`` along ``dim``, a view."""
    return t.narrow(dim, 0 if end == 0 else t.shape[dim] - 1, 1)


def _line(edge: torch.Tensor, w1d: torch.Tensor, dim: int) -> torch.Tensor:
    """The taps a zero pad drops along one border line: a 1-D conv of the
    edge row (dim 2) or column (dim 3), clamped at its ends, by the
    kernel's outer row or column."""
    pad = (1, 1, 0, 0) if dim == 2 else (0, 0, 1, 1)
    return F.conv2d(F.pad(edge, pad, mode="replicate"), w1d)


class _ReplicateConvFused(torch.autograd.Function):
    """The fused conv with a backward of its own: the zero-padded conv's
    input and weight gradients, plus the border lines' and corners' small
    gradients added into their edge rows and columns. Autograd through the
    in-place form pays a full-size copy or zero fill for every sliced update
    and every slice of x instead: ~1.8x the explicit pads' float32 train
    step on an H100 (PERF.md, Findings)."""

    @staticmethod
    def forward(ctx, x, weight):
        out = F.conv2d(x, weight, None, padding=1)
        for end, dim in _LINES:
            _edge(out, end, dim).add_(_line(_edge(x, end, dim), _edge(weight, end, dim), dim))
        for y, xx in _CORNERS:   # taken once: a row and a column line both added them
            out[:, :, y, xx] -= x[:, :, y, xx] @ weight[:, :, y, xx].t()
        ctx.save_for_backward(x, weight)
        ctx.dtype = out.dtype    # the compute dtype: bf16 under autocast
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        xc, wc, g = x.to(ctx.dtype), weight.to(ctx.dtype), g.to(ctx.dtype)
        gx = torch.nn.grad.conv2d_input(xc.shape, wc, g, padding=1)
        gw = torch.nn.grad.conv2d_weight(xc, wc.shape, g, padding=1)
        for end, dim in _LINES:
            with torch.enable_grad():
                edge = _edge(xc, end, dim).detach().requires_grad_()
                w1d = _edge(wc, end, dim).detach().requires_grad_()
                de, dw = torch.autograd.grad(_line(edge, w1d, dim), (edge, w1d),
                                             _edge(g, end, dim))
            _edge(gx, end, dim).add_(de)
            _edge(gw, end, dim).add_(dw)
        for y, xx in _CORNERS:
            gc = g[:, :, y, xx]
            gx[:, :, y, xx] -= gc @ wc[:, :, y, xx]
            gw[:, :, y, xx] -= gc.t() @ xc[:, :, y, xx]
        return gx.to(x.dtype), gw.to(weight.dtype)


def replicate_conv_fused(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 replicate-pad conv of NCHW x with OIHW weight without the padded
    copy of the input (port of ``sifsr_tpu/models/unet.py::
    _replicate_conv_fused``): the interior comes from a zero-padded conv, and
    the border ring, where zero and replicate padding differ, gets the taps
    the zero pad dropped back from the clamped edge rows and columns (each a
    1-D conv of one line), less the four corner taps that a row and a column
    correction both added. Interior pixels are the explicit conv's; border
    pixels take the missing taps in a second addition (~1 ulp).

    The corrections add into slices of the conv's output in place, inside an
    autograd Function whose backward is written out (a float64 ``gradcheck``
    holds it in the tests); it runs under autocast (the compute dtype is the
    conv's) and rematerialisation. The bias is added in the output's dtype,
    as the conv under autocast adds it."""
    out = _ReplicateConvFused.apply(x, weight)
    return out if bias is None else out + bias.to(out.dtype)[None, :, None, None]


class _Conv3x3(nn.Conv2d):
    """``nn.Conv2d`` whose forward takes the fused route when asked to and
    the padding is 'replicate'; its parameters are the plain conv's."""

    fused = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return replicate_conv_fused(x, self.weight, self.bias)
        return super().forward(x)


def Conv3x3(c_in: int, c_out: int, bias: bool = False, padding_mode: str = "replicate",
            pad_impl: str = "explicit") -> nn.Conv2d:
    """3x3 stride-1 conv with replicate (or 'reflect'/'zeros') padding
    (reference model.py:85-159); ``pad_impl='fused'`` takes the fused route
    for replicate padding, as the JAX package's Conv3x3 does."""
    conv = _Conv3x3(c_in, c_out, 3, padding=1, padding_mode=padding_mode, bias=bias)
    conv.fused = pad_impl == "fused" and padding_mode == "replicate"
    return conv


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU)² as the reference's ``bloc`` Sequential."""

    def __init__(self, c_in: int, c_out: int, c_mid: int | None = None,
                 padding_mode: str = "replicate", pad_impl: str = "explicit"):
        super().__init__()
        c_mid = c_mid or c_out
        conv = dict(padding_mode=padding_mode, pad_impl=pad_impl)
        self.bloc = nn.Sequential(
            Conv3x3(c_in, c_mid, **conv), nn.BatchNorm2d(c_mid), nn.ReLU(),
            Conv3x3(c_mid, c_out, **conv), nn.BatchNorm2d(c_out), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bloc(x)


class _ResBlock(nn.Module):
    def __init__(self, c: int, padding_mode: str = "replicate", pad_impl: str = "explicit"):
        super().__init__()
        self.doubleconv = DoubleConv(c, c, padding_mode=padding_mode, pad_impl=pad_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.doubleconv(x)


class DownBlockPool(nn.Module):
    """AvgPool2 -> x + DoubleConv(x) -> Conv/BN/ReLU (reference model.py:458-531)."""

    def __init__(self, c_in: int, c_out: int, padding_mode: str = "replicate",
                 pad_impl: str = "explicit"):
        super().__init__()
        self.resblock = _ResBlock(c_in, padding_mode, pad_impl)
        self.lastconv = nn.Sequential(Conv3x3(c_in, c_out, padding_mode=padding_mode,
                                              pad_impl=pad_impl),
                                      nn.BatchNorm2d(c_out), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lastconv(self.resblock(F.avg_pool2d(x, 2)))


class UpBlock(nn.Module):
    """x2 upsample -> cat(x, skip) -> DoubleConv (reference model.py:161-248).

    bilinear=True (every published model): align-corners bilinear x2 and a
    DoubleConv with mid = in//2. bilinear=False: ``up``, a 2x2 stride-2
    ConvTranspose2d with a bias halving the channels, then a DoubleConv with
    mid = out (reference model.py:210-213)."""

    def __init__(self, c_in: int, c_out: int, padding_mode: str = "replicate",
                 bilinear: bool = True, pad_impl: str = "explicit"):
        super().__init__()
        self.up = None if bilinear else nn.ConvTranspose2d(c_in, c_in // 2, 2, stride=2)
        self.convbloc = DoubleConv(c_in, c_out, c_in // 2 if bilinear else None, padding_mode,
                                   pad_impl)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = upsample_bilinear_x2(x) if self.up is None else self.up(x)
        return self.convbloc(torch.cat([x, skip], dim=1))


class ModelB2(nn.Module):
    """The SIF-CNN-SR network: NHWC (N, H, W, 2) -> (N, H, W, 1) float32;
    train and eval mode through ``.train()`` / ``.eval()`` as any torch
    module. Constructor arguments mirror the reference params JSON
    (paramsB.json modelB_parameters) and the JAX ModelB2."""

    def __init__(self, in_channels: int = 2, downchannels=DOWNCHANNELS,
                 padding_mode: str = "replicate", precision: str = "highest",
                 bilinear: bool = True, dtype: torch.dtype = torch.float32,
                 pad_impl: str = "explicit"):
        super().__init__()
        if pad_impl not in ("explicit", "fused"):
            raise ValueError(f"pad_impl must be 'explicit' or 'fused', got {pad_impl!r}")
        if precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported compute dtype {dtype}")
        self.precision, self.dtype = precision, dtype
        d, pm, pi = tuple(downchannels), padding_mode, pad_impl
        up = 2 if bilinear else 1  # the reference's upfactor (model.py:591)
        self.inbloc = DoubleConv(in_channels, d[0], padding_mode=pm, pad_impl=pi)
        self.db1 = DownBlockPool(d[0], d[1], pm, pi)
        self.db2 = DownBlockPool(d[1], d[2], pm, pi)
        self.db3 = DownBlockPool(d[2], d[3] // up, pm, pi)
        self.ub1 = UpBlock(d[3], d[2] // up, pm, bilinear, pi)
        self.ub2 = UpBlock(d[2], d[1] // up, pm, bilinear, pi)
        self.ub3 = UpBlock(d[1], d[0], pm, bilinear, pi)
        self.outlay = Conv3x3(d[0], 1, bias=True, padding_mode=pm, pad_impl=pi)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Fresh initialisation as the JAX model's: conv kernels, and the
        transposed convs of the ConvTranspose decoder, LeCun-normal (a normal
        of variance 1/fan_in, fan_in = input channels x kernel taps,
        truncated at two standard deviations), biases zero, BatchNorm scale
        one and shift zero, running statistics (0, 1). Drawn on the CPU from
        ``generator`` in the modules' order; the draws differ from JAX's."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    # 0.8796...: the standard deviation of a unit normal truncated at +-2
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    w = torch.empty(m.weight.shape, dtype=torch.float32)
                    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                          generator=generator)
                    m.weight.copy_(w)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()

    def _forward(self, x: torch.Tensor, remat: bool) -> torch.Tensor:
        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        x = x.permute(0, 3, 1, 2)
        s0 = run(self.inbloc, x)
        s1 = run(self.db1, s0)
        s2 = run(self.db2, s1)
        x = run(self.db3, s2)
        x = run(self.ub1, x, s2)
        x = run(self.ub2, x, s1)
        x = run(self.ub3, x, s0)
        return self.outlay(x).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat``: each of the seven blocks runs under
        ``torch.utils.checkpoint``, so only the blocks' inputs are held for
        the backward pass and each block's activations are recomputed there
        (about one extra forward, same numerics). In train mode the
        recomputation updates the BatchNorm running statistics a second
        time: the caller restores them (``train/step.py`` does)."""
        if self.dtype == torch.float32:
            return self._forward(x, remat)
        with torch.autocast(x.device.type, dtype=self.dtype):
            return self._forward(x, remat).to(torch.float32)
