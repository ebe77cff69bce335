"""Hand-written CUDA kernels of the serving path and their plain versions.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain PyTorch version only on a CPU tensor. ``wrapper.launches`` counts the
kernel's launches; ``reset_launches`` sets every count to 0.
"""

from sifsr_tpu_torch.kernels.conv_i8 import (
    conv_i8_exact,
    conv_i8_exact_dual,
    conv_i8_generic,
    conv_i8_in1_split,
)
from sifsr_tpu_torch.kernels.resize_phases import upsample_phases

__all__ = ["KERNELS", "reset_launches", "upsample_phases", "conv_i8_exact",
           "conv_i8_exact_dual", "conv_i8_in1_split", "conv_i8_generic"]

KERNELS = (upsample_phases, conv_i8_in1_split, conv_i8_exact, conv_i8_exact_dual,
           conv_i8_generic)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
