"""The plain reference of ModelB_2 and of whole-area serving, in float32.

ModelB_2 as the paper's reference repository defines it (model.py, with
``paramsB.json``'s ``modelB_parameters``): an input DoubleConv, three
pooled down blocks (2x2 mean pool, a residual DoubleConv, a conv to the
next width), three bilinear up blocks (align-corners x2, concat with the
skip, a DoubleConv with mid = in // 2) and a biased output conv; every
3x3 conv replicate-padded, each followed by BatchNorm and ReLU. Plain
``torch.nn.functional`` calls, NCHW, no kernels of the program, no cache,
TF32 off. ``Ops`` is the one place a conv runs, so that the control (a
lower precision) is this same code with other ``Ops``.

Serving (``predict_area``): normalise with the statistics, cubic x4 of the
LST (``F.interpolate`` bicubic, half-pixel, A = -0.75, clamped taps: cv2's
INTER_CUBIC), the model with BatchNorm on its running statistics,
de-normalise; the area is cut into 64² blocks (partial edge blocks
dropped), and a block whose share of 0 K pixels exceeds ``coverage`` is
zero in the mosaic.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def param_plan(in_channels: int = 2, downchannels=(16, 32, 64, 128)):
    """[(state-dict key, shape, kind)] of the paper's torch ModelB_2 with
    the bilinear decoder, in its ``state_dict()`` order (less
    ``num_batches_tracked``)."""
    c0, c1, c2, c3 = downchannels
    out = []

    def conv(key, cin, cout):
        out.append((key, (cout, cin, 3, 3), "conv"))

    def bn(key, c):
        out.extend([(f"{key}.weight", (c,), "bn_weight"), (f"{key}.bias", (c,), "bn_bias"),
                    (f"{key}.running_mean", (c,), "running_mean"),
                    (f"{key}.running_var", (c,), "running_var")])

    def double(prefix, cin, cout, cmid=None):
        cmid = cmid or cout
        conv(f"{prefix}.0.weight", cin, cmid)
        bn(f"{prefix}.1", cmid)
        conv(f"{prefix}.3.weight", cmid, cout)
        bn(f"{prefix}.4", cout)

    double("inbloc.bloc", in_channels, c0)
    for name, cin, cout in (("db1", c0, c1), ("db2", c1, c2), ("db3", c2, c3 // 2)):
        double(f"{name}.resblock.doubleconv.bloc", cin, cin)
        conv(f"{name}.lastconv.0.weight", cin, cout)
        bn(f"{name}.lastconv.1", cout)
    for name, cin, cout in (("ub1", c3, c2 // 2), ("ub2", c2, c1 // 2), ("ub3", c1, c0)):
        double(f"{name}.convbloc.bloc", cin, cout, cin // 2)
    conv("outlay.weight", c0, 1)
    out.append(("outlay.bias", (1,), "conv_bias"))
    return out


def trainable(in_channels: int = 2, downchannels=(16, 32, 64, 128)) -> list[str]:
    return [k for k, _, kind in param_plan(in_channels, downchannels)
            if kind in ("conv", "bn_weight", "bn_bias", "conv_bias")]


class Ops:
    """Full float32: TF32 off for every conv. ``training`` normalises by the
    batch's moments (BatchNorm in train mode, running statistics untouched),
    else by the running statistics."""

    def __init__(self, training: bool = False):
        self.training = training

    def start(self):
        """Called as a forward pass begins."""

    def conv_bn(self, x, sd, conv_key, bn_key=None, bias=None, relu=True):
        y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), sd[conv_key], bias)
        if bn_key is not None:
            y = F.batch_norm(y, None if self.training else sd[f"{bn_key}.running_mean"],
                             None if self.training else sd[f"{bn_key}.running_var"],
                             sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"], self.training,
                             0.0, BN_EPS)
        return F.relu(y) if relu else y


@contextlib.contextmanager
def full_f32():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def forward(sd: dict, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    """(N, 2, H, W) -> (N, 1, H, W) under ``ops``."""
    def double(x, prefix):
        x = ops.conv_bn(x, sd, f"{prefix}.0.weight", f"{prefix}.1")
        return ops.conv_bn(x, sd, f"{prefix}.3.weight", f"{prefix}.4")

    def down(x, name):
        x = F.avg_pool2d(x, 2)
        x = x + double(x, f"{name}.resblock.doubleconv.bloc")
        return ops.conv_bn(x, sd, f"{name}.lastconv.0.weight", f"{name}.lastconv.1")

    def up(x, skip, name):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return double(torch.cat([x, skip], dim=1), f"{name}.convbloc.bloc")

    ops.start()
    with full_f32():
        s0 = double(x, "inbloc.bloc")
        s1 = down(s0, "db1")
        s2 = down(s1, "db2")
        x = down(s2, "db3")
        x = up(x, s2, "ub1")
        x = up(x, s1, "ub2")
        x = up(x, s0, "ub3")
        return ops.conv_bn(x, sd, "outlay.weight", bias=sd["outlay.bias"], relu=False)


def bicubic_x4(x: torch.Tensor) -> torch.Tensor:
    """cv2 INTER_CUBIC x4 of (N, 1, h, w)."""
    return F.interpolate(x, scale_factor=4, mode="bicubic", align_corners=False)


def model_input(lst_blocks: torch.Tensor, ndvi_blocks: torch.Tensor, stats: dict) -> torch.Tensor:
    """(N, h, h) K and (N, 4h, 4h) NDVI -> the normalised (N, 2, 4h, 4h) input."""
    lst_n = (lst_blocks - stats["mean_lst"]) / stats["std_lst"]
    ndvi_n = (ndvi_blocks - stats["mean_ndvi"]) / stats["std_ndvi"]
    return torch.cat([bicubic_x4(lst_n[:, None]), ndvi_n[:, None]], dim=1)


@torch.no_grad()
def serve_blocks(sd, stats, lst_blocks, ndvi_blocks, ops: Ops) -> torch.Tensor:
    x = model_input(lst_blocks, ndvi_blocks, stats)
    return forward(sd, x, ops)[:, 0] * stats["std_lst"] + stats["mean_lst"]


def tile(a: np.ndarray, win: int) -> np.ndarray:
    gh, gw = a.shape[0] // win, a.shape[1] // win
    a = a[:gh * win, :gw * win]
    return a.reshape(gh, win, gw, win).transpose(0, 2, 1, 3).reshape(gh * gw, win, win)


def predict_area(sd, stats, lst, ndvi, coverage, device, ops: Ops, block: int = 64,
                 factor: int = 4, rows: int = 54) -> np.ndarray:
    """The Kelvin mosaic of an area, ``rows`` blocks at a time."""
    lst = np.asarray(lst, np.float32)
    ndvi = np.clip(np.asarray(ndvi, np.float32), -1.0, 1.0)
    gh, gw = lst.shape[0] // block, lst.shape[1] // block
    lb, nb = tile(lst, block), tile(ndvi, factor * block)
    keep = (lb == 0.0).mean(axis=(1, 2)) <= coverage
    out = np.zeros((len(lb), factor * block, factor * block), np.float32)
    for s in range(0, len(lb), rows):
        sr = serve_blocks(sd, stats, torch.from_numpy(lb[s:s + rows]).to(device),
                          torch.from_numpy(nb[s:s + rows]).to(device), ops)
        out[s:s + rows] = sr.cpu().numpy()
    out[~keep] = 0.0
    f = factor * block
    return out.reshape(gh, gw, f, f).transpose(0, 2, 1, 3).reshape(gh * f, gw * f)
