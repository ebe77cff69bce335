"""Weights across the two packages: flax msgpack -> ModelB2 state dict.

``weights/*/modelB_variables.msgpack`` holds the flax variable tree of the JAX
ModelB2 (``{'params': ..., 'batch_stats': ...}``), written by
``flax.serialization.to_bytes``. The machine with the card has no ``msgpack``
package, so this module decodes the small subset of the format those files
use itself: maps, strings, binaries, arrays, integers, floats, nil/bool and
the flax ndarray extension (ext type 1 holding ``[shape, dtype, bytes]``).

``from_jax_variables`` inverts ``sifsr_tpu/models/convert.py:82-111``: HWIO
kernels become OIHW, BN ``scale/bias/mean/var`` become ``weight/bias/
running_mean/running_var``, under the reference torch model's key names, so
the result loads into ``models.unet.ModelB2`` with ``strict=True`` (as does a
reference ``modelB_state_dict.pt``). ``to_jax_variables`` is its inverse, so
that trained parameters and BatchNorm statistics compare tree against tree.
Both carry the ConvTranspose decoder's ``ub*.up`` (``bilinear=False``): flax's
``ConvTranspose`` kernel (kh, kw, in, out) is the spatially flipped torch
``ConvTranspose2d`` weight (in, out, kh, kw) (``sifsr_tpu/models/convert.py:
96-100``), so the map flips as it transposes.

``from_jax_vgg16`` and ``to_jax_vgg16`` do the same for the LPIPS trunk: the
flax ``VGG16Features`` tree (``conv1_1`` .. ``conv5_3``, HWIO kernels) and
``models.vgg.VGG16Features``'s state dict (torchvision's
``features.<idx>.*`` keys, OIHW).
"""

from __future__ import annotations

import struct
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["unpackb", "load_msgpack_variables", "from_jax_variables", "to_jax_variables",
           "from_jax_vgg16", "to_jax_vgg16"]

_NDARRAY_EXT = 1  # flax.serialization._MsgpackExtType.ndarray


def _decode(buf: memoryview, pos: int):
    """Decode one msgpack object at ``pos``; returns (object, next pos)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _decode_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _decode_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin 8/16/32
               0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str 8/16/32
               0xDC: ">H", 0xDD: ">I",                  # array 16/32
               0xDE: ">H", 0xDF: ">I"}                  # map 16/32
    if b in lengths:
        fmt = lengths[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(buf[pos:pos + n]), pos + n
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
        if b in (0xDC, 0xDD):
            return _decode_array(buf, pos, n)
        return _decode_map(buf, pos, n)
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        return _decode_ext(buf, pos + 1, buf[pos], fixext[b])
    if b in (0xC7, 0xC8, 0xC9):
        fmt = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        return _decode_ext(buf, pos + 1, buf[pos], n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset {pos - 1}")


def _decode_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _decode(buf, pos)
        v, pos = _decode(buf, pos)
        out[k] = v
    return out, pos


def _decode_array(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _decode(buf, pos)
        out.append(v)
    return out, pos


def _decode_ext(buf, pos, code, n):
    if code != _NDARRAY_EXT:
        raise ValueError(f"unsupported msgpack ext type {code}")
    (shape, dtype, data), end = _decode(buf[pos:pos + n], 0)
    if end != n:
        raise ValueError("trailing bytes in an ndarray extension")
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return arr.copy(), pos + n


def unpackb(data: bytes):
    """Decode a whole msgpack document (the subset described above)."""
    obj, pos = _decode(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the msgpack document")
    return obj


def load_msgpack_variables(path: str) -> dict:
    """``*_variables.msgpack`` -> the flax variable tree as numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


# (JAX sub-path, reference torch prefix) of every DoubleConv in ModelB2
def _double_convs():
    yield ("inbloc",), "inbloc.bloc"
    for name in ("db1", "db2", "db3"):
        yield (name, "res"), f"{name}.resblock.doubleconv.bloc"
    for name in ("ub1", "ub2", "ub3"):
        yield (name, "convbloc"), f"{name}.convbloc.bloc"


def _get(tree: dict, path) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def _bn_entries(prefix: str, params: dict, stats: dict) -> dict:
    return {
        f"{prefix}.weight": params["scale"],
        f"{prefix}.bias": params["bias"],
        f"{prefix}.running_mean": stats["mean"],
        f"{prefix}.running_var": stats["var"],
    }


def from_jax_variables(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ModelB2 ``{'params', 'batch_stats'}`` (numpy leaves) -> the
    reference torch state dict that ``models.unet.ModelB2`` loads."""
    params, stats = variables["params"], variables["batch_stats"]
    flat: dict = {}

    def conv(key, kernel):
        flat[key] = np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)  # HWIO->OIHW

    for path, prefix in _double_convs():
        p, s = _get(params, path), _get(stats, path)
        conv(f"{prefix}.0.weight", p["conv1"]["kernel"])
        flat.update(_bn_entries(f"{prefix}.1", p["bn1"], s["bn1"]))
        conv(f"{prefix}.3.weight", p["conv2"]["kernel"])
        flat.update(_bn_entries(f"{prefix}.4", p["bn2"], s["bn2"]))
    for name in ("db1", "db2", "db3"):
        conv(f"{name}.lastconv.0.weight", params[name]["lastconv"]["kernel"])
        flat.update(_bn_entries(f"{name}.lastconv.1", params[name]["lastbn"],
                                stats[name]["lastbn"]))
    conv("outlay.weight", params["outlay"]["kernel"])
    flat["outlay.bias"] = params["outlay"]["bias"]
    for name in ("ub1", "ub2", "ub3"):
        if "up" in params[name]:
            up = params[name]["up"]
            flat[f"{name}.up.weight"] = np.asarray(up["kernel"], np.float32)[::-1, ::-1].transpose(
                2, 3, 0, 1)   # flipped (kh, kw, in, out) -> (in, out, kh, kw)
            flat[f"{name}.up.bias"] = up["bias"]

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in flat.items():
        out[key] = torch.from_numpy(np.array(value, np.float32, order="C"))   # a copy
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def to_jax_variables(state_dict) -> dict:
    """The inverse of ``from_jax_variables``: a ModelB2 state dict (tensors on
    any device, or arrays) -> ``{'params', 'batch_stats'}`` with float32 numpy
    leaves in the JAX ModelB2's tree; ``num_batches_tracked`` is dropped."""
    def arr(key):
        v = state_dict[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return np.ascontiguousarray(v, np.float32)

    def kernel(key):
        return np.ascontiguousarray(arr(key).transpose(2, 3, 1, 0))  # OIHW->HWIO

    def bn(prefix):
        return ({"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")},
                {"mean": arr(f"{prefix}.running_mean"), "var": arr(f"{prefix}.running_var")})

    params: dict = {}
    stats: dict = {}

    def node(tree, path):
        for k in path:
            tree = tree.setdefault(k, {})
        return tree

    for path, prefix in _double_convs():
        p, s = node(params, path), node(stats, path)
        p["conv1"] = {"kernel": kernel(f"{prefix}.0.weight")}
        p["bn1"], s["bn1"] = bn(f"{prefix}.1")
        p["conv2"] = {"kernel": kernel(f"{prefix}.3.weight")}
        p["bn2"], s["bn2"] = bn(f"{prefix}.4")
    for name in ("db1", "db2", "db3"):
        params[name]["lastconv"] = {"kernel": kernel(f"{name}.lastconv.0.weight")}
        params[name]["lastbn"], stats[name]["lastbn"] = bn(f"{name}.lastconv.1")
    params["outlay"] = {"kernel": kernel("outlay.weight"), "bias": arr("outlay.bias")}
    for name in ("ub1", "ub2", "ub3"):
        if f"{name}.up.weight" in state_dict:
            params[name]["up"] = {
                "kernel": np.ascontiguousarray(
                    arr(f"{name}.up.weight").transpose(2, 3, 0, 1)[::-1, ::-1]),
                "bias": arr(f"{name}.up.bias")}
    return {"params": params, "batch_stats": stats}


def _vgg_convs():
    from sifsr_tpu_torch.models.vgg import VGG16_CFG

    return [(name, idx) for name, _, idx in VGG16_CFG if idx is not None]


def from_jax_vgg16(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``VGG16Features`` ``{'params': {conv1_1: {kernel, bias}, ...}}``
    (numpy leaves) -> the state dict of ``models.vgg.VGG16Features``."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, idx in _vgg_convs():
        leaf = variables["params"][name]
        out[f"features.{idx}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(leaf["kernel"], np.float32).transpose(3, 2, 0, 1)))   # HWIO->OIHW
        out[f"features.{idx}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32))
    return out


def to_jax_vgg16(state_dict) -> dict:
    """The inverse of ``from_jax_vgg16``: a ``VGG16Features`` state dict ->
    ``{'params': ...}`` with float32 numpy leaves, HWIO kernels."""
    def arr(key):
        return np.ascontiguousarray(state_dict[key].detach().cpu().numpy(), np.float32)

    return {"params": {name: {"kernel": np.ascontiguousarray(
        arr(f"features.{idx}.weight").transpose(2, 3, 1, 0)), "bias": arr(f"features.{idx}.bias")}
        for name, idx in _vgg_convs()}}
