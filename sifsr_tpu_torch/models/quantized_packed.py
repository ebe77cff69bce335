"""int8 x space-to-depth packed serving: the two serving optimisations of the
JAX package composed.

Port of ``sifsr_tpu/models/quantized_packed.py``. Every conv of the
BN-folded ModelB2 is quantised to int8 in the format of ``kernels.conv_i8``
(per-output-channel weights, an activation scale a layer: the calibrated
static ``in_scale`` when the leaf has one, else a dynamic per-sample
``max|x| / 127``); each quantises its float32 input, runs a replicate-pad
int8 conv with int32 sums and dequantises ``acc * (s_x * scale) + bias``
(ReLU). The level-0 layers (inbloc, ub3, outlay) have packed (3,3,4C,4K)
weights, as in the JAX tree.

The JAX package leaves these convs to XLA. ``F.conv2d`` has no integer path
on CUDA, and a float32 cuDNN conv is not exact (Winograd/FFT algorithms, and
ub1.conv1's 128·9·127² exceeds 2^24), so the port runs every one through its
own int8 conv kernel (``kernels.conv_i8.conv_i8_generic``): 18 launches a
batch. The packed replicate-pad conv equals the unpacked one exactly (each
packed output phase sees each of the 9 taps once; the packed kernel's
quantisation is the packed form of the unpacked one with its scales tiled
x4; the input's scale is a max over the same values), so the int8 packed
step is ``predict --int8``'s forward (``models.quantized.int8_forward``) on
the packed tree un-packed (``unpacked_int8_params``: once by the caller, or
on every call where the step is given the packed tree, as JAX's is): the
same 18 convs at the same shapes. What stays packed is the input: the cubic
x4 into the packed layout, as JAX's step makes it, then un-packed.
``calibrate_packed_scales`` takes its scales from
``models.packed.calibration_record``, the record of the int8 step.

A leaf is ``{'q': int8 HWIO, 'scale': (K,), 'bias': (K,)[, 'in_scale':
()]}``, tensors on the serving device.
"""

from __future__ import annotations

import torch

from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.models.packed import (
    calibration_record,
    depth_to_space,
    pack_serving_params,
    packed_concat,
    packed_inputs,
    space_to_depth,
)
from sifsr_tpu_torch.models.quantized import int8_forward, int8_leaf, with_in_scales

__all__ = ["quantize_packed_params", "unpacked_int8_params", "int8_packed_forward",
           "calibrate_packed_scales", "make_int8_packed_sr_step"]

_PACKED = ("in_conv1", "in_conv2", "ub3_conv1", "ub3_conv2", "outlay")


def quantize_packed_params(variables: dict, device: str | torch.device = "cuda") -> dict:
    """ModelB2 state dict -> the packed serving parameters with every conv
    quantised to int8 (JAX's tree, leaf for leaf): ``mid`` the BN-folded
    db1..db3, ub1, ub2; ``packed`` the level-0 convs {in_conv1, in_conv2,
    ub3_conv1, ub3_conv2, outlay}, ``q`` (3,3,4C,4K), ``scale`` and ``bias``
    (4K,)."""
    dev = resolve_device(device)
    pp = pack_serving_params(variables)

    def walk_mid(node):
        if "kernel" in node:
            return int8_leaf(node["kernel"], node["bias"], dev)
        return {k: walk_mid(v) for k, v in node.items()}

    # the level-0 layers run in packed form: their unpacked copies are not
    # part of the tree, so calibration covers exactly the consumed convs
    mid = {k: v for k, v in pp["mid"].items() if k not in ("inbloc", "ub3", "outlay")}
    return {"mid": walk_mid(mid), "packed": {k: int8_leaf(*pp["packed"][k], dev) for k in _PACKED}}


def _unpack_conv_weights(wp: torch.Tensor) -> torch.Tensor:
    """Packed (3,3,4C,4K) -> HWIO (3,3,C,K): the taps of output phase (0, 0),
    ``W[dy, dx] = Wp[P(dy), P(dx), (q(dy)*2 + q(dx))*C : ..., :K]`` with
    (P, q) = (0, 1), (1, 0), (1, 1) for dy = 0, 1, 2 (``pack_conv_weights``
    at do = eo = 0)."""
    c, k = wp.shape[2] // 4, wp.shape[3] // 4
    taps = ((0, 1), (1, 0), (1, 1))
    rows = []
    for py, qy in taps:
        rows.append(torch.stack([wp[py, px, (qy * 2 + qx) * c:(qy * 2 + qx + 1) * c, :k]
                                 for px, qx in taps]))
    return torch.stack(rows).contiguous()


def unpacked_int8_params(tree: dict) -> dict:
    """The tree of ``quantize_packed_params`` or ``calibrate_packed_scales``
    -> the tree of ``predict --int8`` (``models.quantized.int8_forward``):
    ``mid`` with the five packed leaves un-packed into inbloc, ub3 and
    outlay, the kernel through ``_unpack_conv_weights``, ``scale[:K]`` and
    ``bias[:K]`` (the packed ones are tiled x4), ``in_scale`` as it is.
    Built once for a tree, it spares ``make_int8_packed_sr_step`` and
    ``int8_packed_forward`` the un-packing on every call."""
    def leaf(name):
        pk = tree["packed"][name]
        k = pk["q"].shape[3] // 4
        out = {"q": _unpack_conv_weights(pk["q"]), "scale": pk["scale"][:k].contiguous(),
               "bias": pk["bias"][:k].contiguous()}
        if "in_scale" in pk:
            out["in_scale"] = pk["in_scale"]
        return {"conv": out}

    return dict(tree["mid"],
                inbloc={"conv1": leaf("in_conv1"), "conv2": leaf("in_conv2")},
                ub3={"convbloc": {"conv1": leaf("ub3_conv1"), "conv2": leaf("ub3_conv2")}},
                outlay=leaf("outlay"))


def _int8_tree(params: dict) -> dict:
    """The tree the int8 packed functions run on: ``unpacked_int8_params``
    of a packed tree (a ``'packed'`` key: JAX's form, from
    ``quantize_packed_params`` or ``calibrate_packed_scales``), un-packed on
    every call; else ``params``, already un-packed, as it is."""
    return unpacked_int8_params(params) if "packed" in params else params


@torch.no_grad()
def int8_packed_forward(params: dict, lst_up_packed: torch.Tensor,
                        ndvi_packed: torch.Tensor, c0: int = 16) -> torch.Tensor:
    """The int8 packed forward: packed (N,h,w,4) float32 LST-up and NDVI
    planes -> the packed SR (N,h,w,4) float32. ``params`` is the packed tree
    or its ``unpacked_int8_params``; ``c0`` is inbloc's width, which the tree
    must have. The planes are un-packed and run through ``int8_forward``,
    whose convs are the packed ones."""
    params = _int8_tree(params)
    width = params["inbloc"]["conv1"]["conv"]["q"].shape[3]
    if width != c0:
        raise ValueError(f"c0={c0}, but the tree's inbloc is {width} channels wide")
    x = depth_to_space(packed_concat(lst_up_packed, 1, ndvi_packed, 1), 2)
    return space_to_depth(int8_forward(params, x))


def calibrate_packed_scales(variables: dict, qparams: dict, sample_lst, sample_ndvi, stats,
                            headroom: float = 1.05,
                            device: str | torch.device = "cuda") -> dict:
    """Take ``calibration_record`` (the float32 packed forward, TF32 off)
    on calibration patches, max|x| of each conv's input, and return
    ``qparams`` with a static ``in_scale`` = max / 127 * headroom (0-d
    float32 on ``device``) in every leaf. sample_lst (N,h,h) K, sample_ndvi
    (N,4h,4h)."""
    dev = resolve_device(device)
    rec, mid_rec = calibration_record(variables, sample_lst, sample_ndvi, stats, device=dev)
    # the packed convs' inputs under the record's keys; ub3.conv1 reads
    # concat(up, s0)
    packed = {"in_conv1": rec["in1"], "in_conv2": rec["in2"],
              "ub3_conv1": max(rec["up"], rec["s0"]), "ub3_conv2": rec["u32"],
              "outlay": rec["ol"]}
    amax = {("packed", k): v for k, v in packed.items()}
    amax.update({("mid",) + path: v for path, v in mid_rec.items()})
    return with_in_scales(qparams, amax, headroom, dev)


def make_int8_packed_sr_step(stats, device: str | torch.device = "cuda"):
    """The int8 packed twin of ``inference.make_sr_step``:
    (params, lst (N,h,h) K, ndvi (N,4h,4h)) -> (N,4h,4h) K float32, params
    a ``quantize_packed_params`` tree (dynamic activation scales) or a
    ``calibrate_packed_scales`` one (static) on ``device``: the packed tree
    itself, as JAX's step takes it, or, without the un-packing on every
    call, its ``unpacked_int8_params``. The inputs are made in the packed
    layout, as JAX's step makes them, and un-packed into ``int8_forward``:
    ``conv_i8_generic`` 18 times a batch and no other kernel."""
    dev = resolve_device(device)
    inputs = packed_inputs(stats, dev)

    @torch.no_grad()
    def sr_step(params, lst_blocks, ndvi_blocks):
        lst_up_p, ndvi_p = inputs(lst_blocks, ndvi_blocks)
        x = depth_to_space(packed_concat(lst_up_p, 1, ndvi_p, 1), 2)
        sr = int8_forward(_int8_tree(params), x)[..., 0]
        return sr * stats.std_lst + stats.mean_lst

    return sr_step
