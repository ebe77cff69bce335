"""Weights for the plain reference: a flax ``*_variables.msgpack`` file
decoded into the state-dict naming of the paper's torch ModelB_2, and fresh
weights drawn from a seed on the device.

The decoder is a frozen copy of the subset of msgpack that flax's
``to_bytes`` writes (maps, strings, binaries, arrays, numbers, nil/bool and
the ndarray extension ``[shape, dtype, bytes]``): the card's machine has no
``msgpack`` package, and the reference imports nothing of the program.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from benchmark.reference.modelb2 import param_plan

_NDARRAY_EXT = 1


def _decode(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _items(buf, pos, b & 0x0F, as_map=True)
    if 0x90 <= b <= 0x9F:
        return _items(buf, pos, b & 0x0F, as_map=False)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], pos
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        return struct.unpack_from(fixed[b], buf, pos)[0], pos + struct.calcsize(fixed[b])
    sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
             0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
    if b in sized:
        n = struct.unpack_from(sized[b], buf, pos)[0]
        pos += struct.calcsize(sized[b])
        if b <= 0xC6:
            return bytes(buf[pos:pos + n]), pos + n
        if b <= 0xDB:
            return bytes(buf[pos:pos + n]).decode(), pos + n
        return _items(buf, pos, n, as_map=b >= 0xDE)
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        return _ext(buf, pos + 1, buf[pos], fixext[b])
    if b in (0xC7, 0xC8, 0xC9):
        fmt = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        return _ext(buf, pos + 1, buf[pos], n)
    raise ValueError(f"unsupported msgpack byte 0x{b:02x} at {pos - 1}")


def _items(buf, pos, n, as_map):
    out = {} if as_map else []
    for _ in range(n):
        k, pos = _decode(buf, pos)
        if as_map:
            out[k], pos = _decode(buf, pos)
        else:
            out.append(k)
    return out, pos


def _ext(buf, pos, code, n):
    if code != _NDARRAY_EXT:
        raise ValueError(f"unsupported msgpack ext type {code}")
    (shape, dtype, data), _ = _decode(buf[pos:pos + n], 0)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy(), pos + n


def _flax_path(name: str) -> tuple[str, tuple[str, ...], str]:
    """A torch state-dict key -> (collection, flax path, leaf)."""
    parts = name.split(".")
    leaf = parts[-1]
    block = parts[0]
    if block == "outlay":
        return "params", ("outlay",), {"weight": "kernel", "bias": "bias"}[leaf]
    if parts[1] == "lastconv":                        # dbX.lastconv.{0,1}.*
        sub = ("lastconv",) if parts[2] == "0" else ("lastbn",)
        path = (block, *sub)
    else:                                             # *.bloc.{0,1,3,4}.*
        base = (block, "res") if block.startswith("db") else \
            (block, "convbloc") if block.startswith("ub") else (block,)
        sub = {"0": "conv1", "1": "bn1", "3": "conv2", "4": "bn2"}[parts[-2]]
        path = (*base, sub)
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", path, {"running_mean": "mean", "running_var": "var"}[leaf]
    if path[-1].startswith("bn") or path[-1] == "lastbn":
        return "params", path, {"weight": "scale", "bias": "bias"}[leaf]
    return "params", path, "kernel"


def load_msgpack_state(path: str, device, in_channels: int = 2,
                       downchannels=(16, 32, 64, 128)) -> dict:
    """The flax ``{'params', 'batch_stats'}`` file -> {torch key: float32
    tensor on ``device``} (conv kernels HWIO -> OIHW)."""
    with open(path, "rb") as f:
        data = f.read()
    tree, end = _decode(memoryview(data), 0)
    if end != len(data):
        raise ValueError("trailing bytes after the msgpack document")
    out = {}
    for name, shape, _ in param_plan(in_channels, downchannels):
        coll, fpath, leaf = _flax_path(name)
        node = tree[coll]
        for k in fpath:
            node = node[k]
        a = np.asarray(node[leaf], np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: {a.shape} in the file, {shape} in the model")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def init_state(gen: torch.Generator, device, in_channels: int = 2,
               downchannels=(16, 32, 64, 128)) -> dict:
    """Fresh weights from a seeded device generator, in one draw: conv
    kernels LeCun-normal truncated at two standard deviations, biases zero,
    BatchNorm scale 1 and shift 0, running statistics (0, 1)."""
    plan = param_plan(in_channels, downchannels)
    convs = [(n, s) for n, s, kind in plan if kind == "conv"]
    flat = torch.empty(sum(math.prod(s) for _, s in convs), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, shape, kind in plan:
        if kind == "conv":
            size = math.prod(shape)
            # 0.8796: the standard deviation of a unit normal truncated at +-2
            std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / 0.87962566103423978
            out[name] = (flat[at:at + size] * std).reshape(shape).contiguous()
            at += size
        elif kind in ("bn_weight", "running_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
