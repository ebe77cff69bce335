"""The int8 weight rule of the serving paths.

Port of ``sifsr_tpu/models/quantized.py:37-43``: per-output-channel
symmetric int8 weights, ``scale = max|w_k| / 127`` computed in float64 and
narrowed to float32, values rounded half-to-even and clipped to [-127, 127].
"""

from __future__ import annotations

import numpy as np

__all__ = ["_quantize_kernel"]


def _quantize_kernel(kernel) -> tuple[np.ndarray, np.ndarray]:
    """HWIO float kernel -> (int8 kernel, per-output-channel float32 scale)."""
    kernel = np.asarray(kernel, np.float64)
    scale = np.abs(kernel).max(axis=(0, 1, 2)) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(kernel / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)
