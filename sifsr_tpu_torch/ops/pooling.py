"""Block pooling ops (norm-L4 decimation and 2x2 average pooling).

Port of ``sifsr_tpu/ops/pooling.py``. Norm-L4 pooling is the reference's
physically motivated LST decimation (a radiance-like power mean; reference
utils.py:183-213): split the image into ``k x k`` blocks and return
``(mean(x^4))^(1/4)`` per block, as a reshape and a reduction.
"""

from __future__ import annotations

import torch

__all__ = ["norm_l4_downsample", "avg_pool_2x2", "avg_pool_2x2_nhwc"]


def norm_l4_downsample(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Norm-L4 block pooling on (..., H, W) -> (..., H/f, W/f)."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // factor, factor, w // factor, factor)
    x4 = x * x
    x4 = x4 * x4
    return torch.sqrt(torch.sqrt(x4.mean(dim=(-3, -1))))


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on (..., H, W) (reference model.py:504)."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def avg_pool_2x2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=2, stride=2) on NHWC (N, H, W, C): the DownBlocks'
    pool in the serving models' layout."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
