"""Bicubic upsampling baseline (the evaluation's floor method)."""

from __future__ import annotations

import numpy as np
import torch

from sifsr_tpu_torch.ops.resize import upsample_bicubic


def bicubic_sr(lst_coarse: np.ndarray, factor: int = 4) -> np.ndarray:
    """cv2-convention bicubic x4 of a coarse (H, W) LST patch on the host
    (model_perf_aster_formatds.py:179)."""
    x = torch.as_tensor(np.asarray(lst_coarse, np.float32))
    return upsample_bicubic(x[None], factor)[0].numpy()
