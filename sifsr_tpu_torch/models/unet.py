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
model. Not ported for training: ``pad_impl='fused'`` (the serving model
``models.fused.InferenceModelB2`` has it) and the ``bilinear=False``
ConvTranspose decoder, which no published model uses; both raise
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sifsr_tpu_torch.ops.resize import upsample_bilinear_x2

__all__ = ["ModelB2", "Conv3x3", "DoubleConv", "DownBlockPool", "UpBlock"]

DOWNCHANNELS = (16, 32, 64, 128)  # every published ModelB_2 (paramsB.json)


def Conv3x3(c_in: int, c_out: int, bias: bool = False,
            padding_mode: str = "replicate") -> nn.Conv2d:
    """3x3 stride-1 conv with replicate (or 'reflect'/'zeros') padding
    (reference model.py:85-159)."""
    return nn.Conv2d(c_in, c_out, 3, padding=1, padding_mode=padding_mode, bias=bias)


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU)² as the reference's ``bloc`` Sequential."""

    def __init__(self, c_in: int, c_out: int, c_mid: int | None = None,
                 padding_mode: str = "replicate"):
        super().__init__()
        c_mid = c_mid or c_out
        self.bloc = nn.Sequential(
            Conv3x3(c_in, c_mid, padding_mode=padding_mode), nn.BatchNorm2d(c_mid), nn.ReLU(),
            Conv3x3(c_mid, c_out, padding_mode=padding_mode), nn.BatchNorm2d(c_out), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bloc(x)


class _ResBlock(nn.Module):
    def __init__(self, c: int, padding_mode: str = "replicate"):
        super().__init__()
        self.doubleconv = DoubleConv(c, c, padding_mode=padding_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.doubleconv(x)


class DownBlockPool(nn.Module):
    """AvgPool2 -> x + DoubleConv(x) -> Conv/BN/ReLU (reference model.py:458-531)."""

    def __init__(self, c_in: int, c_out: int, padding_mode: str = "replicate"):
        super().__init__()
        self.resblock = _ResBlock(c_in, padding_mode)
        self.lastconv = nn.Sequential(Conv3x3(c_in, c_out, padding_mode=padding_mode),
                                      nn.BatchNorm2d(c_out), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lastconv(self.resblock(F.avg_pool2d(x, 2)))


class UpBlock(nn.Module):
    """Align-corners bilinear x2 -> cat(x, skip) -> DoubleConv(mid = in//2)
    (reference model.py:161-248, bilinear=True as in every published model)."""

    def __init__(self, c_in: int, c_out: int, padding_mode: str = "replicate"):
        super().__init__()
        self.convbloc = DoubleConv(c_in, c_out, c_in // 2, padding_mode)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convbloc(torch.cat([upsample_bilinear_x2(x), skip], dim=1))


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
        if pad_impl != "explicit":
            raise NotImplementedError(
                f"pad_impl={pad_impl!r} is not ported for the training model (the serving "
                "model has it; ROADMAP.md): use pad_impl='explicit'")
        if not bilinear:
            raise NotImplementedError(
                "the bilinear=False ConvTranspose decoder is not ported (ROADMAP.md)")
        if precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported compute dtype {dtype}")
        self.precision, self.dtype = precision, dtype
        d, pm = tuple(downchannels), padding_mode
        self.inbloc = DoubleConv(in_channels, d[0], padding_mode=pm)
        self.db1 = DownBlockPool(d[0], d[1], pm)
        self.db2 = DownBlockPool(d[1], d[2], pm)
        self.db3 = DownBlockPool(d[2], d[3] // 2, pm)
        self.ub1 = UpBlock(d[3], d[2] // 2, pm)
        self.ub2 = UpBlock(d[2], d[1] // 2, pm)
        self.ub3 = UpBlock(d[1], d[0], pm)
        self.outlay = Conv3x3(d[0], 1, bias=True, padding_mode=pm)

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
