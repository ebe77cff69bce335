"""The XLA int8 mid chain of the ``mid='xla'`` serving step.

Port of ``sifsr_tpu/models/quantized_packed.py:66-107``: every mid-chain conv
(db1..db3, ub1, ub2 at 128²/64²/32²) quantises its float32 input with the
calibrated static scale (``round(x / s_x)``, a division, half-to-even,
clipped to [-127, 127]), runs a replicate-pad int8 conv with int32 sums and
dequantises ``acc * (s_x * scale) + bias`` (ReLU). The JAX package leaves
that conv to XLA. ``F.conv2d`` has no integer path on CUDA, and a float32
cuDNN conv is not exact (Winograd/FFT algorithms, and ub1.conv1's
128·9·127² exceeds 2^24), so the port runs it through its own int8 conv
kernel (``kernels.conv_i8.conv_i8_generic``).

A leaf is ``{'q': int8 HWIO, 'scale': (K,), 'bias': (K,), 'in_scale': ()}``,
tensors on the serving device.
"""

from __future__ import annotations

import torch

from sifsr_tpu_torch.kernels.conv_i8 import conv_i8_generic

__all__ = ["_quant", "_conv_i8_mid", "_double_mid", "_down"]


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) -> int8; ``scale`` a 0-d float32
    tensor on x's device (a true division, as in the JAX package)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _conv_i8_mid(x: torch.Tensor, leaf: dict, relu: bool = True) -> torch.Tensor:
    s_x = leaf["in_scale"]
    return conv_i8_generic(_quant(x.to(torch.float32), s_x), leaf["q"],
                           s_x * leaf["scale"], leaf["bias"], relu)


def _double_mid(x: torch.Tensor, tree: dict) -> torch.Tensor:
    x = _conv_i8_mid(x, tree["conv1"]["conv"])
    return _conv_i8_mid(x, tree["conv2"]["conv"])


def _down_body(x: torch.Tensor, tree: dict) -> torch.Tensor:
    x = x + _double_mid(x, tree["res"])
    return _conv_i8_mid(x, tree["lastconv"]["conv"])


def _down(x: torch.Tensor, tree: dict) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return _down_body(x, tree)
