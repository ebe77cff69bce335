"""The control for int8: the plain reference with BatchNorm folded into
each conv, the folded kernels quantised per output channel and each
conv's input per tensor to int4 ([-7, 7]), with static input scales
calibrated, as the int8 step's are, on the first fully valid blocks of
the set-up granule."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.modelb2 import BN_EPS, Ops, serve_blocks, tile


class Int4Ops(Ops):
    """Eval only. ``calibrating`` records max|x| of each conv input in call
    order; afterwards each conv fake-quantises with those scales."""

    LEVELS = 7

    def __init__(self):
        super().__init__(training=False)
        self.amax: list[float] = []
        self.calibrating = True
        self._i = 0

    def start(self):
        self._i = 0

    def conv_bn(self, x, sd, conv_key, bn_key=None, bias=None, relu=True):
        w = sd[conv_key]
        if bn_key is not None:
            s = sd[f"{bn_key}.weight"] / torch.sqrt(sd[f"{bn_key}.running_var"] + BN_EPS)
            w = w * s[:, None, None, None]
            bias = sd[f"{bn_key}.bias"] - sd[f"{bn_key}.running_mean"] * s
        i = self._i
        self._i += 1
        if self.calibrating:
            self.amax.append(max(self.amax[i] if i < len(self.amax) else 0.0,
                                 float(x.abs().max())))
        else:
            sx = self.amax[i] / self.LEVELS
            x = torch.clamp(torch.round(x / sx), -self.LEVELS, self.LEVELS) * sx
            sw = w.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12) / self.LEVELS
            w = torch.clamp(torch.round(w / sw), -self.LEVELS, self.LEVELS) * sw
        y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), w, bias)
        return F.relu(y) if relu else y


def serving_ops(cfg, sd, calib, dev) -> Ops:
    """Int4Ops calibrated on the first ``calibration_blocks`` fully valid
    blocks of the set-up granule ``calib`` (lst, ndvi)."""
    ops = Int4Ops()
    lb = tile(calib[0], cfg["lst_block"])
    nb = tile(np.clip(calib[1], -1, 1), cfg["factor"] * cfg["lst_block"])
    sel = np.nonzero((lb != 0).all(axis=(1, 2)))[0][:cfg["serve"]["calibration_blocks"]]
    serve_blocks(sd, cfg["statistics"], torch.from_numpy(lb[sel]).to(dev),
                 torch.from_numpy(nb[sel]).to(dev), ops)
    ops.calibrating = False
    return ops
