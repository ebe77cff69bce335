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
``TorchBatchNorm`` reproduces. The decoder upsample is the align-corners
matrix of ``ops.resize`` (two matmuls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sifsr_tpu_torch.ops.resize import upsample_bilinear_x2

__all__ = ["ModelB2", "Conv3x3", "DoubleConv", "DownBlockPool", "UpBlock"]

DOWNCHANNELS = (16, 32, 64, 128)  # every published ModelB_2 (paramsB.json)


def Conv3x3(c_in: int, c_out: int, bias: bool = False) -> nn.Conv2d:
    """3x3 stride-1 conv with replicate padding (reference model.py:85-159)."""
    return nn.Conv2d(c_in, c_out, 3, padding=1, padding_mode="replicate", bias=bias)


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU)² as the reference's ``bloc`` Sequential."""

    def __init__(self, c_in: int, c_out: int, c_mid: int | None = None):
        super().__init__()
        c_mid = c_mid or c_out
        self.bloc = nn.Sequential(
            Conv3x3(c_in, c_mid), nn.BatchNorm2d(c_mid), nn.ReLU(),
            Conv3x3(c_mid, c_out), nn.BatchNorm2d(c_out), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bloc(x)


class _ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.doubleconv = DoubleConv(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.doubleconv(x)


class DownBlockPool(nn.Module):
    """AvgPool2 -> x + DoubleConv(x) -> Conv/BN/ReLU (reference model.py:458-531)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.resblock = _ResBlock(c_in)
        self.lastconv = nn.Sequential(Conv3x3(c_in, c_out), nn.BatchNorm2d(c_out), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lastconv(self.resblock(F.avg_pool2d(x, 2)))


class UpBlock(nn.Module):
    """Align-corners bilinear x2 -> cat(x, skip) -> DoubleConv(mid = in//2)
    (reference model.py:161-248, bilinear=True as in every published model)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.convbloc = DoubleConv(c_in, c_out, c_in // 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convbloc(torch.cat([upsample_bilinear_x2(x), skip], dim=1))


class ModelB2(nn.Module):
    """The SIF-CNN-SR network: NHWC (N, H, W, 2) -> (N, H, W, 1), eval-mode
    use through ``.eval()`` as any torch module."""

    def __init__(self):
        super().__init__()
        d = DOWNCHANNELS
        self.inbloc = DoubleConv(2, d[0])
        self.db1 = DownBlockPool(d[0], d[1])
        self.db2 = DownBlockPool(d[1], d[2])
        self.db3 = DownBlockPool(d[2], d[3] // 2)
        self.ub1 = UpBlock(d[3], d[2] // 2)
        self.ub2 = UpBlock(d[2], d[1] // 2)
        self.ub3 = UpBlock(d[1], d[0])
        self.outlay = Conv3x3(d[0], 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        s0 = self.inbloc(x)
        s1 = self.db1(s0)
        s2 = self.db2(s1)
        x = self.db3(s2)
        x = self.ub1(x, s2)
        x = self.ub2(x, s1)
        x = self.ub3(x, s0)
        return self.outlay(x).permute(0, 2, 3, 1)
