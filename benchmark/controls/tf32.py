"""The control for float32 with TF32 off: the plain reference with every
conv's operands rounded to TF32's 10-bit mantissa (round to nearest even)
and float32 accumulation, which is what a TF32 tensor-core conv computes;
the same arithmetic on any device."""

from __future__ import annotations

import torch

from benchmark.reference.modelb2 import Ops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even);
    the gradient passes through unchanged."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -8192
    return x + (b.view(torch.float32) - x).detach()


class Tf32Ops(Ops):
    def conv_bn(self, x, sd, conv_key, bn_key=None, bias=None, relu=True):
        sd = {**sd, conv_key: round_tf32(sd[conv_key])}
        return super().conv_bn(round_tf32(x), sd, conv_key, bn_key, bias, relu)


def serving_ops(cfg, sd, calib, dev) -> Ops:
    return Tf32Ops()


def training_ops() -> Ops:
    return Tf32Ops(training=True)
