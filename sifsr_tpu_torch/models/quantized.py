"""The int8 serving path of ``predict --int8``: weight rule, calibration,
forward and step.

Port of ``sifsr_tpu/models/quantized.py``. The BN-folded ModelB2 is served
with

- weights: per-output-channel symmetric int8 (``scale = max|w_k| / 127``
  computed in float64 and narrowed to float32, values rounded half-to-even
  and clipped to [-127, 127]), quantised once from the folded kernels;
- activations: int8 per layer, at the calibrated static ``in_scale`` when the
  leaf has one (``round(x / s_x)``, a division by a 0-d device tensor), else
  at a dynamic per-sample scale ``max|x| / 127``;
- convs: replicate-pad int8 x int8 with int32 sums, then dequantise, bias and
  ReLU in float32, intermediates float32.

The JAX package leaves these convs to XLA (``lax.conv_general_dilated`` on
int8). PyTorch has no integer conv on CUDA, so they run through the port's
int8 conv kernel with the float32 epilogue (``kernels.conv_i8.conv_i8_generic``);
the kernel takes whole 4-channel words, so inbloc.conv1's two input channels
are zero-padded to four.

A leaf is ``{'q': int8 HWIO, 'scale': (K,), 'bias': (K,)[, 'in_scale': ()]}``,
tensors on the serving device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sifsr_tpu_torch.device import full_f32_convs, resolve_device
from sifsr_tpu_torch.kernels.conv_i8 import conv_i8_generic
from sifsr_tpu_torch.models.fused import fold_batchnorm, upsample_bilinear_x2_nhwc
from sifsr_tpu_torch.ops.resize import upsample_bicubic

__all__ = ["quantize_serving_params", "calibrate_activation_scales", "int8_forward",
           "make_int8_sr_step"]


def _quantize_kernel(kernel) -> tuple[np.ndarray, np.ndarray]:
    """HWIO float kernel -> (int8 kernel, per-output-channel float32 scale)."""
    kernel = np.asarray(kernel, np.float64)
    scale = np.abs(kernel).max(axis=(0, 1, 2)) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(kernel / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_serving_params(variables: dict, device: str | torch.device = "cuda") -> dict:
    """ModelB2 state dict -> BN-folded, weight-quantised tree on ``device``:
    each conv becomes {'q': int8 HWIO, 'scale': (K,), 'bias': (K,)}."""
    dev = resolve_device(device)

    def walk(node):
        if "kernel" in node:
            q, s = _quantize_kernel(node["kernel"].numpy())
            return {"q": torch.from_numpy(q).to(dev), "scale": torch.from_numpy(s).to(dev),
                    "bias": node["bias"].to(dev, torch.float32)}
        return {k: walk(v) for k, v in node.items()}

    return walk(fold_batchnorm(variables))


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) -> int8; ``scale`` a float32 tensor on
    x's device (a true division, as in the JAX package: a Python-float
    divisor would become a multiplication by its reciprocal on CUDA)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _conv_i8(x: torch.Tensor, leaf: dict, relu: bool = True) -> torch.Tensor:
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
    x_q = _quant(xf, s_x)
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


def _double(x, tree):
    x = _conv_i8(x, tree["conv1"]["conv"])
    return _conv_i8(x, tree["conv2"]["conv"])


def _pool2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _down(x, tree):
    x = _pool2(x)
    x = x + _double(x, tree["res"])
    return _conv_i8(x, tree["lastconv"]["conv"])


def _up(x, skip, tree):
    return _double(torch.cat([upsample_bilinear_x2_nhwc(x), skip], dim=-1), tree["convbloc"])


@torch.no_grad()
def int8_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Quantised BN-folded forward; x (N, H, W, 2) float32 -> (N, H, W, 1)."""
    s0 = _double(x, params["inbloc"])
    s1 = _down(s0, params["db1"])
    s2 = _down(s1, params["db2"])
    x = _down(s2, params["db3"])
    x = _up(x, s2, params["ub1"])
    x = _up(x, s1, params["ub2"])
    x = _up(x, s0, params["ub3"])
    return _conv_i8(x, params["outlay"]["conv"], relu=False)


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
    """Run the float32 BN-folded forward on calibration patches, record
    max|input| of every conv, and return ``qparams`` with a static
    ``in_scale`` (0-d float32 tensor) in every leaf.

    sample_lst (N,64,64) Kelvin, sample_ndvi (N,256,256). calib_quantile:
    None records max|x| per conv input; a quantile (e.g. 0.9999) clips that
    tail for tighter scales."""
    dev = resolve_device(device)
    folded = fold_batchnorm(variables)
    scales: dict = {}

    def record(path, arr):
        if calib_quantile is None:
            m = float(arr.abs().max())
        else:
            m = float(np.quantile(arr.abs().cpu().numpy().ravel(), calib_quantile))
        scales[path] = m / 127.0 * headroom

    def conv_f32(xx, path, relu=True):
        node = folded
        for k in path:
            node = node[k]
        record(path, xx)
        xp = F.pad(xx.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
        yy = F.conv2d(xp, node["kernel"].to(dev).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        yy = yy + node["bias"].to(dev)
        return torch.clamp_min(yy, 0.0) if relu else yy

    def double_f32(xx, base):
        xx = conv_f32(xx, base + ("conv1", "conv"))
        return conv_f32(xx, base + ("conv2", "conv"))

    def down_f32(xx, base):
        xx = _pool2(xx)
        xx = xx + double_f32(xx, base + ("res",))
        return conv_f32(xx, base + ("lastconv", "conv"))

    def up_f32(xx, skip, base):
        return double_f32(torch.cat([upsample_bilinear_x2_nhwc(xx), skip], dim=-1),
                          base + ("convbloc",))

    with full_f32_convs():
        s0 = double_f32(_normalised_input(sample_lst, sample_ndvi, stats, dev), ("inbloc",))
        s1 = down_f32(s0, ("db1",))
        s2 = down_f32(s1, ("db2",))
        t = down_f32(s2, ("db3",))
        t = up_f32(t, s2, ("ub1",))
        t = up_f32(t, s1, ("ub2",))
        t = up_f32(t, s0, ("ub3",))
        conv_f32(t, ("outlay", "conv"), relu=False)

    def attach(node, path=()):
        if "q" in node:
            return dict(node, in_scale=torch.tensor(scales[path], dtype=torch.float32,
                                                    device=dev))
        return {k: attach(v, path + (k,)) for k, v in node.items()}

    return attach(qparams)
