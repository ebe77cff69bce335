"""Fixed directional-derivative filter bank for the perceptual loss.

Port of ``sifsr_tpu/ops/filters.py``. The SIF-NN-SR1 objective compares
Sobel-family responses of the SR output and of the NDVI image (reference
train_model_B_predef_filters.py:38-42,120-130): ``F.conv2d``, a
cross-correlation with zero 'same' padding, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sobel_bank", "directional_gradients"]

_SOBEL_BANK = np.asarray(
    [
        [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],    # vertical gradient
        [[1, 0, -1], [2, 0, -2], [1, 0, -1]],    # horizontal gradient
        [[2, 1, 0], [1, 0, -1], [0, -1, -2]],    # main-diagonal gradient
        [[0, 1, 2], [-1, 0, 1], [-2, -1, 0]],    # anti-diagonal gradient
    ],
    dtype=np.float32,
)


@functools.lru_cache(maxsize=None)
def sobel_bank(dtype_name: str = "float32") -> np.ndarray:
    """The 4-filter bank as HWIO weights (3, 3, 1, 4), the JAX package's form."""
    return _SOBEL_BANK.transpose(1, 2, 0)[:, :, None, :].astype(dtype_name)


@functools.lru_cache(maxsize=16)
def _bank(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The bank as OIHW weights (4, 1, 3, 3) for ``F.conv2d``."""
    return torch.as_tensor(_SOBEL_BANK[:, None], dtype=dtype, device=device)


def directional_gradients(x: torch.Tensor) -> torch.Tensor:
    """Cross-correlate a single-channel NHWC batch with the 4-filter bank.

    x: (N, H, W, 1) -> (N, H, W, 4), zero 'same' padding (torch parity).
    """
    y = F.conv2d(x.permute(0, 3, 1, 2), _bank(x.dtype, x.device), padding=1)
    return y.permute(0, 2, 3, 1)
