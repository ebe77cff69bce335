"""Space-to-depth packed serving: the packed float step and the packed
forms of the 256²-level layers.

Port of ``sifsr_tpu/models/packed.py``. The JAX package serves the
256²-level layers (inbloc, ub3, outlay) on a 2x2 space-to-depth packed
layout (N, 128, 128, 4C), packed channel ``(q*2 + r)*C + c`` for pixel phase
(q, r), to fill TPU lanes:

- a 3x3 conv C->D becomes a 3x3 conv 4C->4D with
  ``Wp[p+1, s+1, (q,r,c), (do,eo,k)] = W[2p+q-do+1, 2s+r-eo+1, c, k]``;
- the replicate pad replicates the outermost original row/column into both
  phase slots (``_replicate_pad_packed``);
- db1's AvgPool2 is the mean over the four phases of the packed map;
- integer-factor resizes emit packed outputs through per-phase matrices.

``make_packed_sr_step`` runs that graph as JAX does: a comparison step of
the float path (``inference.make_sr_step`` is the port's float step), its
convs ``F.conv2d`` as JAX's are XLA convs. The packed convs do four times
the MACs of the unpacked ones. The port's int8 kernels work on the unpacked
NHWC tensors instead (the packed conv equals the unpacked replicate-pad
conv, weights and scales included).

The int8 steps are calibrated on this graph, so that their record matches
JAX's tensor by tensor: ``calibration_record`` runs ``packed_forward`` in
float32 with an observer, which sees each tensor that gets an int8 scale of
its own. ``models.int8_serving`` and ``models.quantized_packed`` build their
parameters from that record.
"""

from __future__ import annotations

import functools
import operator

import numpy as np
import torch
import torch.nn.functional as F

from sifsr_tpu_torch.device import full_f32, full_f32_convs, resolve_device
from sifsr_tpu_torch.models.fused import fold_batchnorm_numpy
from sifsr_tpu_torch.ops.pooling import avg_pool_2x2_nhwc
from sifsr_tpu_torch.ops.quantile import quantile_linear
from sifsr_tpu_torch.ops.resize import resize_matrix, upsample_bilinear_x2_nhwc

__all__ = ["pack_conv_weights", "pack_serving_params", "packed_step_params", "space_to_depth",
           "depth_to_space", "packed_concat", "packed_inputs", "packed_forward",
           "calibration_record", "make_packed_sr_step"]


def pack_conv_weights(w, b) -> tuple[np.ndarray, np.ndarray]:
    """HWIO (3,3,C,K) + bias (K,) -> packed (3,3,4C,4K) + bias (4K,)."""
    w = np.asarray(w)
    b = np.asarray(b)
    c_in, c_out = w.shape[2], w.shape[3]
    wp = np.zeros((3, 3, 4 * c_in, 4 * c_out), np.float32)
    for p in (-1, 0, 1):
        for s in (-1, 0, 1):
            for q in (0, 1):
                for r in (0, 1):
                    for do in (0, 1):
                        for eo in (0, 1):
                            dy = 2 * p + q - do + 1
                            dx = 2 * s + r - eo + 1
                            if 0 <= dy < 3 and 0 <= dx < 3:
                                wp[p + 1, s + 1,
                                   (q * 2 + r) * c_in : (q * 2 + r + 1) * c_in,
                                   (do * 2 + eo) * c_out : (do * 2 + eo + 1) * c_out] = w[dy, dx]
    bp = np.concatenate([b] * 4).astype(np.float32)
    return wp, bp


@functools.lru_cache(maxsize=None)
def _pad_perms(c: int) -> tuple:
    """Channel permutations of the packed replicate pad: the pad row/col takes
    the border packed pixel with its phase slot replaced by the outermost
    original row/col (q->0 at top, q->1 at bottom, r likewise)."""
    j = np.arange(4 * c)
    q, r, ch = j // (2 * c), (j // c) % 2, j % c
    return (
        tuple((r * c + ch).tolist()),            # top: (0, r, c)
        tuple(((2 + r) * c + ch).tolist()),      # bottom: (1, r, c)
        tuple((q * 2 * c + ch).tolist()),        # left: (q, 0, c)
        tuple(((q * 2 + 1) * c + ch).tolist()),  # right: (q, 1, c)
    )


def _replicate_pad_packed(x: torch.Tensor, c: int) -> torch.Tensor:
    """Packed-space replicate pad by one packed pixel on each side."""
    perm_top, perm_bottom, perm_left, perm_right = (list(p) for p in _pad_perms(c))
    x = torch.cat([x[:, :1, :, perm_top], x, x[:, -1:, :, perm_bottom]], dim=1)
    return torch.cat([x[:, :, :1, perm_left], x, x[:, :, -1:, perm_right]], dim=2)


@functools.lru_cache(maxsize=None)
def _phase_matrices(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """(2, out_size//2, in_size) per-phase rows of a resampling matrix."""
    a = resize_matrix(in_size, out_size, kind)
    return np.stack([a[0::2], a[1::2]]).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _phase_tensor(in_size: int, out_size: int, kind: str, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``_phase_matrices`` as a tensor, uploaded once per device and dtype."""
    return torch.as_tensor(_phase_matrices(in_size, out_size, kind), dtype=dtype, device=device)


def _packed_resize(x: torch.Tensor, phases) -> torch.Tensor:
    """(N, h, w, C) -> packed (N, H/2, W/2, 4C) of the resized image."""
    n, h, w, c = x.shape
    phases = torch.as_tensor(phases, dtype=x.dtype, device=x.device)
    t = torch.einsum("dih,nhwc->ndiwc", phases, x)
    y = torch.einsum("ejw,ndiwc->nijdec", phases, t)
    return y.reshape(n, y.shape[1], y.shape[2], 4 * c)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channel order (q, r, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor, c: int) -> torch.Tensor:
    n, h, w, _ = x.shape
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def packed_concat(a: torch.Tensor, ca: int, b: torch.Tensor, cb: int) -> torch.Tensor:
    """Concat along the original channel dim inside each (q, r) slot."""
    n, h, w, _ = a.shape
    return torch.cat([a.reshape(n, h, w, 4, ca), b.reshape(n, h, w, 4, cb)],
                     dim=-1).reshape(n, h, w, 4 * (ca + cb))


def pack_serving_params(state_dict: dict) -> dict:
    """ModelB2 state dict -> {'mid': the BN-folded tree, 'packed': the
    level-0 convs (inbloc, ub3.convbloc, outlay) packed}, float32 numpy on
    the host."""
    folded = fold_batchnorm_numpy(state_dict)

    def grab(tree):
        return tree["kernel"], tree["bias"]

    packed = {
        "in_conv1": pack_conv_weights(*grab(folded["inbloc"]["conv1"]["conv"])),
        "in_conv2": pack_conv_weights(*grab(folded["inbloc"]["conv2"]["conv"])),
        "ub3_conv1": pack_conv_weights(*grab(folded["ub3"]["convbloc"]["conv1"]["conv"])),
        "ub3_conv2": pack_conv_weights(*grab(folded["ub3"]["convbloc"]["conv2"]["conv"])),
        "outlay": pack_conv_weights(*grab(folded["outlay"]["conv"])),
    }
    return {"mid": folded, "packed": packed}


def packed_step_params(state_dict: dict, compute_dtype: torch.dtype = torch.bfloat16,
                       device: str | torch.device = "cuda") -> dict:
    """``pack_serving_params``'s tree as tensors on ``device`` in
    ``compute_dtype``, moved and cast once (JAX's
    ``pack_serving_params(variables, dtype)``): the parameters of
    ``make_packed_sr_step``."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return torch.as_tensor(node).to(dev, compute_dtype)

    return walk(pack_serving_params(state_dict))


def _conv(x: torch.Tensor, kernel, bias, relu: bool) -> torch.Tensor:
    """VALID conv of a pre-padded NHWC tensor with an HWIO kernel (a tensor,
    or a numpy array moved to x's device), + bias [-> ReLU]."""
    k = torch.as_tensor(kernel, device=x.device).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    y = y + torch.as_tensor(bias, device=x.device)
    return torch.clamp_min(y, 0) if relu else y


def _packed_conv(x: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, c_in: int,
                 relu: bool = True) -> torch.Tensor:
    return _conv(_replicate_pad_packed(x, c_in), wp, bp, relu)


def _ignore(key, x) -> None:
    """The float step's observer: it records nothing."""


def _mid_conv(x: torch.Tensor, mid: dict, path: tuple, observe) -> torch.Tensor:
    observe(path, x)
    node = functools.reduce(operator.getitem, path, mid)
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    return _conv(x, node["kernel"], node["bias"], True)


def _mid_double(x, mid, base, observe):
    x = _mid_conv(x, mid, base + ("conv1", "conv"), observe)
    return _mid_conv(x, mid, base + ("conv2", "conv"), observe)


def _mid_down(x, mid, name, observe):
    """DownBlock ``name`` minus its pool: residual DoubleConv + lastconv."""
    x = x + _mid_double(x, mid, (name, "res"), observe)
    return _mid_conv(x, mid, (name, "lastconv", "conv"), observe)


def _mid_up(x, skip, mid, name, key, observe):
    """UpBlock ``name``; ``key`` names its x2 upsample for ``observe``."""
    up = upsample_bilinear_x2_nhwc(x)
    observe(key, up)
    return _mid_double(torch.cat([up, skip], dim=-1), mid, (name, "convbloc"), observe)


def packed_forward(params: dict, lst_up_packed: torch.Tensor, ndvi_packed: torch.Tensor,
                   c0: int = 16, observe=_ignore) -> torch.Tensor:
    """Packed serving forward. Inputs: packed (N,h,w,4) LST-up and NDVI
    planes (phase-major, one channel each); output the packed SR
    (N,h,w,4), all in the parameters' dtype.

    ``observe(key, x)`` sees, in graph order, each tensor that the int8
    steps quantise at a scale of its own: a mid conv's input under its path
    in ``params['mid']`` (``('db1', 'res', 'conv1', 'conv')``, ...), the
    others under the names below (``u32`` and ``ol``: the inputs of
    ub3.conv2 and the outlay). The float step observes nothing;
    ``calibration_record`` records."""
    mid = params["mid"]
    pk = params["packed"]

    x = packed_concat(lst_up_packed, 1, ndvi_packed, 1)           # (N,h,w,8)
    observe("in1", x)
    x = _packed_conv(x, *pk["in_conv1"], c_in=2)
    observe("in2", x)
    s0p = _packed_conv(x, *pk["in_conv2"], c_in=c0)                # (N,h,w,4*16)
    observe("s0", s0p)

    n, h, w, _ = s0p.shape
    # db1's AvgPool2 of the 2x-resolution s0 is the mean over the (q, r)
    # phases of the packed map
    s1 = _mid_down(s0p.reshape(n, h, w, 4, c0).mean(dim=3), mid, "db1", observe)  # (N,h,w,32)
    observe("m_s1", s1)
    s2 = _mid_down(avg_pool_2x2_nhwc(s1), mid, "db2", observe)     # (N,h/2,w/2,64)
    observe("m_s2", s2)
    x = _mid_down(avg_pool_2x2_nhwc(s2), mid, "db3", observe)      # (N,h/4,w/4,64)
    observe("m_t3", x)
    x = _mid_up(x, s2, mid, "ub1", "m_upt3", observe)              # 32 @ h/4
    observe("m_u1", x)
    x = _mid_up(x, s1, mid, "ub2", "m_upu1", observe)              # 16 @ h/2
    observe("m_u2", x)

    # ub3: packed bilinear x2 of the 16-channel map, packed concat with s0p
    h2 = x.shape[1]
    up_p = _packed_resize(x, _phase_tensor(h2, 2 * h2, "linear_ac", x.dtype, x.device))
    observe("up", up_p)
    x = packed_concat(up_p, c0, s0p, c0)                           # (N,h,w,128)
    x = _packed_conv(x, *pk["ub3_conv1"], c_in=2 * c0)
    observe("u32", x)
    x = _packed_conv(x, *pk["ub3_conv2"], c_in=c0)
    observe("ol", x)
    return _packed_conv(x, *pk["outlay"], c_in=c0, relu=False)    # (N,h,w,4)


@torch.no_grad()
def calibration_record(variables: dict, sample_lst, sample_ndvi, stats, calib_quantile=None,
                       device: str | torch.device = "cuda"):
    """The int8 steps' calibration record (JAX's ``_f32_packed_mirror``,
    key for key): ``packed_forward`` in float32 (cuDNN's TF32 off) on the
    packed tree of a ModelB2 state dict and calibration patches, sample_lst
    (N,h,h) K and sample_ndvi (N,4h,4h). Returns (record, mid record): max|x|
    (or the ``calib_quantile`` of |x|) of each tensor the forward observes,
    by name in the first and by tree path in the second."""
    dev = resolve_device(device)
    rec: dict = {}
    mid_rec: dict = {}

    def observe(key, x):
        if calib_quantile is None:
            m = float(x.abs().max())
        else:
            m = float(quantile_linear(x.abs().reshape(-1), calib_quantile))
        (mid_rec if isinstance(key, tuple) else rec)[key] = m

    with full_f32_convs():
        # the inputs as JAX's mirror makes them: Python-float divisors (the
        # steps divide by 0-d tensors, which CUDA does not round alike)
        lst_n = (torch.as_tensor(sample_lst, dtype=torch.float32, device=dev)
                 - stats.mean_lst) / stats.std_lst
        ndvi_n = (torch.as_tensor(sample_ndvi, dtype=torch.float32, device=dev)
                  - stats.mean_ndvi) / stats.std_ndvi
        h = lst_n.shape[1]
        lst_up_p = _packed_resize(lst_n[..., None], _phase_matrices(h, 4 * h, "cubic"))
        packed_forward(pack_serving_params(variables), lst_up_p,
                       space_to_depth(ndvi_n[..., None]), observe=observe)
    return rec, mid_rec


def packed_inputs(stats, dev: torch.device):
    """(lst (N,h,h) K, ndvi (N,4h,4h)) -> float32 packed (N,2h,2h,4) inputs:
    normalise (dividing by 0-d float32 tensors made here once, as the int8
    steps do), the cubic x4 of the LST straight into the packed layout in
    full float32, NDVI space-to-depth."""
    mean_lst, std_lst, mean_ndvi, std_ndvi = (
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in (stats.mean_lst, stats.std_lst, stats.mean_ndvi, stats.std_ndvi))

    def inputs(lst_blocks, ndvi_blocks):
        lst_n = (torch.as_tensor(lst_blocks, dtype=torch.float32, device=dev) - mean_lst) / std_lst
        ndvi_n = (torch.as_tensor(ndvi_blocks, dtype=torch.float32, device=dev)
                  - mean_ndvi) / std_ndvi
        h = lst_n.shape[1]
        with full_f32():
            lst_up_p = _packed_resize(lst_n[..., None],
                                      _phase_tensor(h, 4 * h, "cubic", torch.float32, dev))
        return lst_up_p, space_to_depth(ndvi_n[..., None])

    return inputs


def make_packed_sr_step(stats, compute_dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cuda"):
    """The packed twin of ``inference.make_sr_step``:
    (params, lst (N,h,h) K, ndvi (N,4h,4h)) -> (N,4h,4h) K float32, params
    from ``packed_step_params(state_dict, compute_dtype, device)``.

    Normalisation and the cubic x4 run in float32 and are cast to
    ``compute_dtype`` afterwards; the network runs in ``compute_dtype``. A
    float32 step runs its convs and einsums with TF32 off (JAX's HIGHEST)."""
    dev = resolve_device(device)
    exact = compute_dtype == torch.float32
    inputs = packed_inputs(stats, dev)

    @torch.no_grad()
    def sr_step(params, lst_blocks, ndvi_blocks):
        lst_up_p, ndvi_p = inputs(lst_blocks, ndvi_blocks)
        with full_f32(exact):
            sr_p = packed_forward(params, lst_up_p.to(compute_dtype), ndvi_p.to(compute_dtype))
        sr = depth_to_space(sr_p.to(torch.float32), 1)[..., 0]
        return sr * stats.std_lst + stats.mean_lst

    return sr_step
