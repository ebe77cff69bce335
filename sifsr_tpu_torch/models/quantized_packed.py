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
tensors on the serving device. The chain's functions are those of
``models.quantized`` (``predict --int8`` runs the same convs over the whole
model): with a static ``in_scale`` its ``_conv_i8`` is this module's
``_conv_i8_mid``.
"""

from __future__ import annotations

from sifsr_tpu_torch.models.quantized import _conv_i8 as _conv_i8_mid
from sifsr_tpu_torch.models.quantized import _double as _double_mid
from sifsr_tpu_torch.models.quantized import _down, _quant

__all__ = ["_quant", "_conv_i8_mid", "_double_mid", "_down"]
