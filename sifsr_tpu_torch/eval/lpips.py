"""LPIPS perceptual distance (port of ``sifsr_tpu/eval/lpips.py``;
reference lpips.py:140-359 semantics).

Pipeline (matching the reference's piq-vendored ContentLoss with
distance='mse', mean=[0,0,0], std=[1,1,1], as called at
model_perf_aster_formatds.py:134,405-410):

1. inputs are [0,1]-rescaled single-channel crops replicated to 3 channels;
2. VGG16 features at relu1_2..relu5_3 (``models.vgg.VGG16Features``);
3. unit-normalise each feature vector along channels as x / (||x|| + 1e-10);
4. per-layer 1x1 "LPIPS weights" (non-negative learned weights);
5. MSE distance per layer, mean over space, weighted sum over layers,
   mean over batch.

The trunk and the distance run on ``device`` in full float32
(``device.full_f32``: no TF32 in cuDNN or cuBLAS), as the JAX package runs
at ``Precision.HIGHEST``. Weights are offline inputs: ``vgg16_path`` a torch
VGG16 state_dict, ``lpips_weights_path`` a torch file with the 5 per-layer
weight vectors (the piq release asset). Without them ``available`` is False
and ``__call__`` returns NaN, so result tables carry an explicit gap.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sifsr_tpu_torch.device import full_f32, resolve_device
from sifsr_tpu_torch.models.vgg import LPIPS_LAYERS, VGG16Features, convert_torchvision_vgg16

__all__ = ["LPIPS"]


class LPIPS:
    def __init__(
        self,
        vgg16_path: str | None = None,
        lpips_weights_path: str | None = None,
        replicate_gray: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        weight_dir = os.environ.get("SIFSR_WEIGHTS_DIR", "weights")
        vgg16_path = vgg16_path or os.path.join(weight_dir, "vgg16_features.pt")
        lpips_weights_path = lpips_weights_path or os.path.join(weight_dir, "lpips_weights.pt")
        self.replicate_gray = replicate_gray
        self.available = os.path.exists(vgg16_path) and os.path.exists(lpips_weights_path)
        if not self.available:
            return

        vgg_sd = torch.load(vgg16_path, map_location="cpu", weights_only=True)
        self._model = VGG16Features()
        self._model.load_state_dict(convert_torchvision_vgg16(vgg_sd))
        self._model = self._model.to(self.device).eval()
        lp = torch.load(lpips_weights_path, map_location="cpu", weights_only=True)
        if isinstance(lp, dict):
            lp = list(lp.values())
        self._layer_weights = [torch.as_tensor(np.asarray(w, np.float32).reshape(-1),
                                               device=self.device) for w in lp]

    @torch.no_grad()
    def _distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with full_f32():
            taps_a = self._model(a)
            taps_b = self._model(b)
            total = 0.0
            for layer, w in zip(LPIPS_LAYERS, self._layer_weights):
                fa, fb = taps_a[layer], taps_b[layer]
                # piq normalises as x / (||x|| + eps), NOT x / sqrt(||x||²+eps)
                # (reference lpips.py:281-292)
                fa = fa / (torch.sqrt(torch.sum(fa * fa, dim=1, keepdim=True)) + 1e-10)
                fb = fb / (torch.sqrt(torch.sum(fb * fb, dim=1, keepdim=True)) + 1e-10)
                sq = torch.square(fa - fb) * w[None, :, None, None]
                total = total + torch.mean(torch.sum(sq, dim=1), dim=(1, 2))
            return torch.mean(total)

    def __call__(self, pred: np.ndarray, target: np.ndarray) -> float:
        """LPIPS between two (H, W) images already rescaled to [0, 1]."""
        if not self.available:
            return float("nan")
        a = torch.as_tensor(np.asarray(pred, np.float32), device=self.device)[None, None]
        b = torch.as_tensor(np.asarray(target, np.float32), device=self.device)[None, None]
        if self.replicate_gray:
            a = a.expand(1, 3, *a.shape[2:])
            b = b.expand(1, 3, *b.shape[2:])
        return float(self._distance(a, b))
