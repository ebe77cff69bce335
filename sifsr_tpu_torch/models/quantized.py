"""The int8 serving path of ``predict --int8``: the forward skeleton, its
int8 layers, calibration and step.

Port of ``sifsr_tpu/models/quantized.py``. The BN-folded ModelB2 is served
in the int8 format of ``kernels.conv_i8`` (the one owner of its rules):

- weights: per-output-channel symmetric int8 (``quantize_kernel``),
  quantised once from the folded kernels;
- activations: int8 per layer (``quantize_activation``), at the calibrated
  static ``in_scale`` when the leaf has one, else at a dynamic per-sample
  scale ``max|x| / 127``;
- convs: replicate-pad int8 x int8 with int32 sums, then dequantise, bias and
  ReLU in float32, intermediates float32.

The JAX package leaves these convs to XLA (``lax.conv_general_dilated`` on
int8). PyTorch has no integer conv on CUDA, so they run through the port's
int8 conv kernel with the float32 epilogue (``kernels.conv_i8.conv_i8_generic``);
the kernel takes whole 4-channel words, so inbloc.conv1's two input channels
are zero-padded to four.

ModelB2's graph on unpacked NHWC tensors is written once,
``modelb2_forward(conv, x)``, with the layer as a parameter: ``conv(x, path,
relu=True)`` runs the conv at ``path`` of the folded tree. ``int8_forward``
passes the int8 convs of a parameter tree (``int8_layers``);
``calibrate_activation_scales`` passes float32 replicate-pad convs that
record their inputs. ``models.int8_serving``'s ``mid='xla'`` chain runs the
same blocks (``down_block``, ``up_block``) on its own tree.

A leaf is ``{'q': int8 HWIO, 'scale': (K,), 'bias': (K,)[, 'in_scale': ()]}``,
tensors on the serving device.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch
import torch.nn.functional as F

from sifsr_tpu_torch.device import full_f32_convs, resolve_device
from sifsr_tpu_torch.kernels.conv_i8 import (
    activation_scale,
    conv_i8_generic,
    quantize_activation,
    quantize_kernel,
)
from sifsr_tpu_torch.models.fused import (
    fold_batchnorm,
    fold_batchnorm_numpy,
    upsample_bilinear_x2_nhwc,
)
from sifsr_tpu_torch.ops.pooling import avg_pool_2x2_nhwc
from sifsr_tpu_torch.ops.quantile import quantile_linear
from sifsr_tpu_torch.ops.resize import upsample_bicubic

__all__ = ["int8_leaf", "quantize_serving_params", "with_in_scales", "int8_conv", "int8_layers",
           "down_block", "up_block", "modelb2_forward", "int8_forward",
           "calibrate_activation_scales", "make_int8_sr_step"]


def int8_leaf(kernel, bias, dev: torch.device) -> dict:
    """A float HWIO kernel and its bias -> the leaf {'q': int8 HWIO, 'scale':
    (K,), 'bias': (K,)} on ``dev``."""
    q, s = quantize_kernel(kernel)
    return {"q": torch.from_numpy(q).to(dev), "scale": torch.from_numpy(s).to(dev),
            "bias": torch.as_tensor(np.asarray(bias, np.float32)).to(dev)}


def quantize_serving_params(variables: dict, device: str | torch.device = "cuda") -> dict:
    """ModelB2 state dict -> BN-folded, weight-quantised tree on ``device``:
    each conv an ``int8_leaf``."""
    dev = resolve_device(device)

    def walk(node):
        if "kernel" in node:
            return int8_leaf(node["kernel"], node["bias"], dev)
        return {k: walk(v) for k, v in node.items()}

    return walk(fold_batchnorm_numpy(variables))


def with_in_scales(qparams: dict, amax: dict, headroom: float, dev: torch.device) -> dict:
    """``qparams`` with a static ``in_scale`` (0-d float32 on ``dev``) in
    every leaf: ``activation_scale`` of the max|x| that ``amax`` holds
    under the leaf's path."""
    def attach(node, path=()):
        if "q" in node:
            return dict(node, in_scale=torch.tensor(activation_scale(amax[path], headroom),
                                                    dtype=torch.float32, device=dev))
        return {k: attach(v, path + (k,)) for k, v in node.items()}

    return attach(qparams)


def _at(tree: dict, path: tuple):
    """The node of ``tree`` at ``path``, a tuple of keys."""
    return functools.reduce(operator.getitem, path, tree)


def int8_conv(x: torch.Tensor, leaf: dict, relu: bool = True) -> torch.Tensor:
    """NHWC float -> int8 -> replicate-pad int8 conv -> dequantise -> bias
    [-> ReLU], float32 out (``quantized.py:66-98``).

    With a static ``in_scale`` the kernel's epilogue is the whole dequantise,
    ``acc * (s_x * scale) + bias``. The dynamic scale differs per sample, so
    the kernel returns float(acc) (scale 1, bias 0) and the same two float32
    operations follow as tensor ops."""
    xf = x.to(torch.float32)
    static = "in_scale" in leaf
    if static:
        s_x = leaf["in_scale"]
    else:
        s_x = torch.clamp_min(xf.abs().amax(dim=(1, 2, 3), keepdim=True), 1e-12) / 127.0
    x_q = quantize_activation(xf, s_x)
    q = leaf["q"]
    pad = -q.shape[2] % 4
    if pad:                       # whole 4-channel words: zero channels add nothing
        x_q = F.pad(x_q, (0, pad))
        q = F.pad(q, (0, 0, 0, pad))
    if static:
        return conv_i8_generic(x_q, q, s_x * leaf["scale"], leaf["bias"], relu)
    acc = conv_i8_generic(x_q, q, torch.ones_like(leaf["scale"]), torch.zeros_like(leaf["bias"]),
                          relu=False)
    y = acc * (s_x * leaf["scale"]) + leaf["bias"]
    return torch.clamp_min(y, 0.0) if relu else y


def int8_layers(params: dict):
    """The ``conv`` of ``modelb2_forward`` for an int8 tree: (x, path, relu)
    -> ``int8_conv`` of the leaf at ``path`` of ``params``."""
    def conv(x, path, relu=True):
        return int8_conv(x, _at(params, path), relu)
    return conv


def _double(conv, x, base):
    x = conv(x, base + ("conv1", "conv"))
    return conv(x, base + ("conv2", "conv"))


def down_block(conv, x, name: str):
    """DownBlock ``name``: 2x2 pool, residual DoubleConv, lastconv."""
    x = avg_pool_2x2_nhwc(x)
    x = x + _double(conv, x, (name, "res"))
    return conv(x, (name, "lastconv", "conv"))


def up_block(conv, x, skip, name: str):
    """UpBlock ``name``: DoubleConv of concat(bilinear x2 of x, skip)."""
    return _double(conv, torch.cat([upsample_bilinear_x2_nhwc(x), skip], dim=-1),
                   (name, "convbloc"))


def modelb2_forward(conv, x: torch.Tensor) -> torch.Tensor:
    """ModelB2's graph on NHWC x (N, H, W, 2) -> (N, H, W, 1), each layer
    ``conv(x, path, relu=True)`` for its path in the folded tree
    (``('db1', 'res', 'conv1', 'conv')``, ...)."""
    s0 = _double(conv, x, ("inbloc",))
    s1 = down_block(conv, s0, "db1")
    s2 = down_block(conv, s1, "db2")
    x = down_block(conv, s2, "db3")
    x = up_block(conv, x, s2, "ub1")
    x = up_block(conv, x, s1, "ub2")
    x = up_block(conv, x, s0, "ub3")
    return conv(x, ("outlay", "conv"), relu=False)


@torch.no_grad()
def int8_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Quantised BN-folded forward; x (N, H, W, 2) float32 -> (N, H, W, 1)."""
    return modelb2_forward(int8_layers(params), x)


def _normalised_input(lst, ndvi, stats, dev) -> torch.Tensor:
    lst_n = (torch.as_tensor(lst, dtype=torch.float32, device=dev) - stats.mean_lst) / stats.std_lst
    ndvi_n = (torch.as_tensor(ndvi, dtype=torch.float32, device=dev)
              - stats.mean_ndvi) / stats.std_ndvi
    return torch.stack([upsample_bicubic(lst_n, 4), ndvi_n], dim=-1)


def make_int8_sr_step(stats, device: str | torch.device = "cuda"):
    """The int8 twin of ``inference.make_sr_step``:
    (quantised params, lst (N,64,64) K, ndvi (N,256,256)) -> (N,256,256) K."""
    dev = resolve_device(device)

    @torch.no_grad()
    def sr_step(params, lst_blocks, ndvi_blocks):
        x = _normalised_input(lst_blocks, ndvi_blocks, stats, dev)
        sr = int8_forward(params, x)[..., 0]
        return sr * stats.std_lst + stats.mean_lst

    return sr_step


@torch.no_grad()
def calibrate_activation_scales(variables: dict, qparams: dict, sample_lst, sample_ndvi, stats,
                                headroom: float = 1.05, calib_quantile: float | None = None,
                                device: str | torch.device = "cuda") -> dict:
    """Run ``modelb2_forward`` in float32 on the BN-folded tree and
    calibration patches, record max|input| of every conv, and return
    ``qparams`` with a static ``in_scale`` (0-d float32 tensor) in every
    leaf.

    sample_lst (N,64,64) Kelvin, sample_ndvi (N,256,256). calib_quantile:
    None records max|x| per conv input; a quantile (e.g. 0.9999) clips that
    tail for tighter scales."""
    dev = resolve_device(device)
    folded = fold_batchnorm(variables)
    amax: dict = {}

    def conv_f32(xx, path, relu=True):
        """The float32 replicate-pad conv of the folded layer at ``path``,
        recording its input."""
        if calib_quantile is None:
            amax[path] = float(xx.abs().max())
        else:
            amax[path] = float(quantile_linear(xx.abs().reshape(-1), calib_quantile))
        node = _at(folded, path)
        xp = F.pad(xx.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
        yy = F.conv2d(xp, node["kernel"].to(dev).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        yy = yy + node["bias"].to(dev)
        return torch.clamp_min(yy, 0.0) if relu else yy

    with full_f32_convs():
        modelb2_forward(conv_f32, _normalised_input(sample_lst, sample_ndvi, stats, dev))
    return with_in_scales(qparams, amax, headroom, dev)
