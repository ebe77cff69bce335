"""Hand-written CUDA kernels of the serving and training paths and their
plain versions.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain PyTorch version only on a CPU tensor. ``wrapper.launches`` counts the
kernel's launches (``fused_psf_downscale`` counts its backward launches
apart, in ``.backward_launches``); ``reset_launches`` sets every count to 0.
"""

from sifsr_tpu_torch.kernels.conv_i8 import (
    conv_i8_exact,
    conv_i8_exact_dual,
    conv_i8_generic,
    conv_i8_in1,
    conv_i8_in1_split,
    conv_i8_outlay,
)
from sifsr_tpu_torch.kernels.conv_px import (
    conv_prow,
    conv_prow_dual,
    conv_prow_dual_planes,
    conv_prow_split_pool,
    conv_prow_up2,
    conv_prow_up2_pack,
)
from sifsr_tpu_torch.kernels.fused_ops import fused_norm_l4, fused_psf_downscale
from sifsr_tpu_torch.kernels.resize_phases import upsample_phases

__all__ = ["KERNELS", "reset_launches", "upsample_phases", "conv_i8_exact",
           "conv_i8_exact_dual", "conv_i8_in1_split", "conv_i8_generic", "conv_prow",
           "conv_prow_split_pool", "conv_prow_up2", "conv_prow_dual_planes",
           "conv_prow_up2_pack", "conv_i8_in1", "conv_i8_outlay", "conv_prow_dual",
           "fused_psf_downscale", "fused_norm_l4"]

KERNELS = (upsample_phases, conv_i8_in1_split, conv_i8_exact, conv_i8_exact_dual,
           conv_i8_generic, conv_prow, conv_prow_split_pool, conv_prow_up2,
           conv_prow_dual_planes, conv_prow_up2_pack, conv_i8_in1, conv_i8_outlay,
           conv_prow_dual, fused_psf_downscale, fused_norm_l4)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    fused_psf_downscale.backward_launches = 0
