"""VGG16 feature trunk for LPIPS (port of ``sifsr_tpu/models/vgg.py``).

The reference's LPIPS (lpips.py:140-359, vendored from piq) downloads a
pretrained torchvision VGG16 plus LPIPS layer weights at runtime. There is
no network here and no torchvision, so the weights are *inputs*: a
torch-format VGG16 ``state_dict`` in torchvision's layout
(``features.<idx>.weight/bias``, or ``<idx>.*`` for a saved ``features``
``Sequential``). Without weights the LPIPS metric is NaN and flagged
(``eval.lpips.LPIPS.available``).

Architecture: torchvision VGG16 ``features`` up to relu5_3 (13 convs with
zero padding 1, 4 max pools that floor odd sizes), NCHW, returning the
activations the LPIPS metric uses: relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3. The modules sit at torchvision's indices, so torchvision's keys
load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["LPIPS_LAYERS", "VGG16_CFG", "VGG16Features", "convert_torchvision_vgg16"]

# (name, out_channels, torchvision features index)
VGG16_CFG = [
    ("conv1_1", 64, 0), ("conv1_2", 64, 2), ("pool", None, None),
    ("conv2_1", 128, 5), ("conv2_2", 128, 7), ("pool", None, None),
    ("conv3_1", 256, 10), ("conv3_2", 256, 12), ("conv3_3", 256, 14), ("pool", None, None),
    ("conv4_1", 512, 17), ("conv4_2", 512, 19), ("conv4_3", 512, 21), ("pool", None, None),
    ("conv5_1", 512, 24), ("conv5_2", 512, 26), ("conv5_3", 512, 28),
]

LPIPS_LAYERS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")
_TAP_AFTER = {"conv1_2": "relu1_2", "conv2_2": "relu2_2", "conv3_3": "relu3_3",
              "conv4_3": "relu4_3", "conv5_3": "relu5_3"}


class VGG16Features(nn.Module):
    """NCHW VGG16 feature trunk returning the 5 LPIPS tap activations."""

    def __init__(self):
        super().__init__()
        layers, self._taps, c_in = [], {}, 3
        for name, ch, _ in VGG16_CFG:
            if name == "pool":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(c_in, ch, 3, padding=1), nn.ReLU()]
            c_in = ch
            if name in _TAP_AFTER:
                self._taps[len(layers) - 1] = _TAP_AFTER[name]
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> dict:
        taps = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps[self._taps[i]] = x
        return taps


def convert_torchvision_vgg16(state_dict: dict) -> dict:
    """torchvision VGG16 state_dict -> ``VGG16Features`` state_dict.

    Accepts either the full-model key layout (``features.N.weight/bias``) or a
    features-only ``Sequential`` state_dict (``N.weight/bias``), since users may
    save ``vgg16().state_dict()`` or ``vgg16().features.state_dict()``; the
    classifier's keys are left out.
    """
    prefix = "features." if any(k.startswith("features.") for k in state_dict) else ""
    out = {}
    for name, _, idx in VGG16_CFG:
        if idx is None:
            continue
        for part in ("weight", "bias"):
            out[f"features.{idx}.{part}"] = torch.as_tensor(
                state_dict[f"{prefix}{idx}.{part}"]).to(torch.float32)
    return out
