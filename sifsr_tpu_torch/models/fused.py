"""Inference ModelB: BatchNorm folded into the conv weights.

Port of ``sifsr_tpu/models/fused.py``. At inference BN is an affine map with
frozen statistics, so it folds exactly into the preceding conv:

    y = scale * (conv(x, W) - mean) / sqrt(var + eps) + bias
      = conv(x, W * s) + (bias - mean * s),   s = scale / sqrt(var + eps)

``fold_batchnorm`` turns a ModelB2 state dict into the JAX package's folded
tree (``{name: {'conv1': {'conv': {'kernel': HWIO, 'bias'}}, ...}}``, the
layout the int8 builders and the tests read), and ``InferenceModelB2`` is the
U-Net with one biased conv per layer (conv -> bias -> ReLU) built from it.

``pad_impl`` picks how a layer pads: 'explicit' materialises the replicate
pad (``nn.Conv2d(padding_mode='replicate')``); 'fused' is
``models.unet.replicate_conv_fused`` (the training model's fused route), a
zero-padded conv plus O(H+W) corrections of the border ring, which differs
from 'explicit' only by the float summation order at border pixels.
"""

from __future__ import annotations

import torch
from torch import nn

from sifsr_tpu_torch.models.unet import DOWNCHANNELS, Conv3x3, replicate_conv_fused
from sifsr_tpu_torch.ops.resize import upsample_bilinear_x2, upsample_bilinear_x2_nhwc

__all__ = ["InferenceModelB2", "fold_batchnorm", "fold_batchnorm_numpy",
           "upsample_bilinear_x2_nhwc", "replicate_conv_fused"]

_BN_EPS = 1e-5


def _fold_pair(weight_oihw: torch.Tensor, sd: dict, bn: str) -> dict:
    # the float64 root of the float32 var + eps, rounded to float32, is the
    # correctly rounded float32 root (JAX's); torch's vectorised float32 sqrt
    # on the CPU can be an ulp off it
    root = torch.sqrt((sd[f"{bn}.running_var"] + _BN_EPS).to(torch.float64)).to(torch.float32)
    s = sd[f"{bn}.weight"] / root
    kernel = weight_oihw.permute(2, 3, 1, 0) * s[None, None, None, :]   # HWIO
    bias = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * s
    return {"conv": {"kernel": kernel.contiguous(), "bias": bias}}


def _fold_double(sd: dict, prefix: str) -> dict:
    return {
        "conv1": _fold_pair(sd[f"{prefix}.0.weight"], sd, f"{prefix}.1"),
        "conv2": _fold_pair(sd[f"{prefix}.3.weight"], sd, f"{prefix}.4"),
    }


def fold_batchnorm(state_dict: dict) -> dict:
    """ModelB2 state dict -> the folded tree of float32 tensors, kernels HWIO
    (the JAX package's ``fold_batchnorm(variables)['params']``)."""
    sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    out: dict = {"inbloc": _fold_double(sd, "inbloc.bloc")}
    for name in ("db1", "db2", "db3"):
        out[name] = {
            "res": _fold_double(sd, f"{name}.resblock.doubleconv.bloc"),
            "lastconv": _fold_pair(sd[f"{name}.lastconv.0.weight"], sd, f"{name}.lastconv.1"),
        }
    for name in ("ub1", "ub2", "ub3"):
        out[name] = {"convbloc": _fold_double(sd, f"{name}.convbloc.bloc")}
    out["outlay"] = {"conv": {"kernel": sd["outlay.weight"].permute(2, 3, 1, 0).contiguous(),
                              "bias": sd["outlay.bias"]}}
    return out


def fold_batchnorm_numpy(state_dict: dict) -> dict:
    """``fold_batchnorm``'s tree as float32 numpy arrays on the host: what
    the int8 builders quantise and pack."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.detach().cpu().numpy()

    return walk(fold_batchnorm(state_dict))


class _FusedConv(nn.Module):
    """3x3 replicate-pad conv -> bias [-> ReLU]."""

    def __init__(self, c_in: int, c_out: int, relu: bool = True):
        super().__init__()
        self.conv = Conv3x3(c_in, c_out, bias=True)
        self.relu = relu

    def forward(self, x: torch.Tensor, pad_impl: str = "explicit") -> torch.Tensor:
        if pad_impl == "fused":
            x = replicate_conv_fused(x, self.conv.weight, self.conv.bias)
        else:
            x = self.conv(x)
        return torch.relu(x) if self.relu else x


class _FusedDouble(nn.Module):
    def __init__(self, c_in: int, c_out: int, c_mid: int | None = None):
        super().__init__()
        c_mid = c_mid or c_out
        self.conv1 = _FusedConv(c_in, c_mid)
        self.conv2 = _FusedConv(c_mid, c_out)

    def forward(self, x: torch.Tensor, pad_impl: str = "explicit") -> torch.Tensor:
        return self.conv2(self.conv1(x, pad_impl), pad_impl)


class _FusedDown(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.res = _FusedDouble(c_in, c_in)
        self.lastconv = _FusedConv(c_in, c_out)

    def forward(self, x: torch.Tensor, pad_impl: str = "explicit") -> torch.Tensor:
        x = torch.nn.functional.avg_pool2d(x, 2)
        return self.lastconv(x + self.res(x, pad_impl), pad_impl)


class _FusedUp(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.convbloc = _FusedDouble(c_in, c_out, c_in // 2)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                pad_impl: str = "explicit") -> torch.Tensor:
        return self.convbloc(torch.cat([upsample_bilinear_x2(x), skip], dim=1), pad_impl)


class InferenceModelB2(nn.Module):
    """BN-folded ModelB2 for serving: NHWC (N, H, W, 2) -> (N, H, W, 1).
    Submodule names follow the folded tree (``db1.res.conv1.conv`` ...).
    ``forward``'s pad_impl is 'explicit' or 'fused' (see the module
    docstring; ``inference.make_sr_step`` validates and chooses it)."""

    def __init__(self):
        super().__init__()
        d = DOWNCHANNELS
        self.inbloc = _FusedDouble(2, d[0])
        self.db1 = _FusedDown(d[0], d[1])
        self.db2 = _FusedDown(d[1], d[2])
        self.db3 = _FusedDown(d[2], d[3] // 2)
        self.ub1 = _FusedUp(d[3], d[2] // 2)
        self.ub2 = _FusedUp(d[2], d[1] // 2)
        self.ub3 = _FusedUp(d[1], d[0])
        self.outlay = _FusedConv(d[0], 1, relu=False)

    @classmethod
    def from_folded(cls, folded: dict) -> "InferenceModelB2":
        """Build from ``fold_batchnorm``'s tree (kernels HWIO -> OIHW)."""
        model = cls()
        sd = {}

        def walk(node, prefix):
            if "kernel" in node:
                sd[f"{prefix}.weight"] = node["kernel"].permute(3, 2, 0, 1)
                sd[f"{prefix}.bias"] = node["bias"]
                return
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)

        walk(folded, "")
        model.load_state_dict(sd, strict=True)
        return model.eval()

    @classmethod
    def from_variables(cls, state_dict: dict) -> "InferenceModelB2":
        """ModelB2 state dict -> folded serving model (float32, on the CPU)."""
        return cls.from_folded(fold_batchnorm(state_dict))

    def forward(self, x: torch.Tensor, pad_impl: str = "explicit") -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        s0 = self.inbloc(x, pad_impl)
        s1 = self.db1(s0, pad_impl)
        s2 = self.db2(s1, pad_impl)
        x = self.db3(s2, pad_impl)
        x = self.ub1(x, s2, pad_impl)
        x = self.ub2(x, s1, pad_impl)
        x = self.ub3(x, s0, pad_impl)
        return self.outlay(x, pad_impl).permute(0, 2, 3, 1)
