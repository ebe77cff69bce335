"""The yardstick of HAT's cell: the FLOPs of one forward, and the bytes and
FLOPs of the overlapping cross-attention and of the channel-attention
branch, from the configuration's widths alone, so that a change to the
program cannot move them. The window attention of the HABs is SwinIR's,
measured by ``swin_yardstick.window_attention_work``."""

from __future__ import annotations

import math

from benchmark.harness.swin_yardstick import ATTN_BACKWARD_FACTOR, F32_BYTES


def overlap_window(p: dict) -> int:
    """The side of an OCAB key/value window."""
    return int(p["window_size"] * p["overlap_ratio"]) + p["window_size"]


def hat_forward_flops(p: dict, h: int, w: int) -> float:
    """FLOPs (2 x multiply-adds) of one HAT forward on an h x w LR grid
    (padded to the window, as the network pads it): every Linear, both
    attentions' products (q kᵀ and attn v: window² keys a query in a HAB,
    overlap² in an OCAB), every conv, the CAB's two 1x1s on the pooled map
    included. Norms, softmax, GELU, the pool, the gate's product, biases
    and adds are left out."""
    win, ow = p["window_size"], overlap_window(p)
    h, w = h + (-h) % win, w + (-w) % win
    e, nf, r = p["embed_dim"], p["num_feat"], p["upscale"]
    hidden = int(e * p["mlp_ratio"])
    compressed, squeezed = e // p["compress_ratio"], e // p["squeeze_factor"]
    px = h * w
    linears = 4 * e * e + 2 * e * hidden                            # qkv, proj, fc1, fc2
    hab = linears + 2 * win * win * e + 2 * 9 * e * compressed       # + attention, CAB 3x3s
    ocab = linears + 2 * ow * ow * e
    macs = px * (sum(p["depths"]) * hab + len(p["depths"]) * (ocab + 9 * e * e))
    macs += sum(p["depths"]) * 2 * e * squeezed                      # the CAB's 1x1s
    macs += px * 9 * (p["in_chans"] * e + e * e + e * nf)           # first, after body, before up
    for _ in range(int(math.log2(r))):                              # conv nf -> 4 nf, shuffle x2
        macs += px * 9 * nf * 4 * nf
        px *= 4
    macs += px * 9 * nf                                             # conv_last, nf -> 1
    return 2.0 * macs


def ocab_attention_work(windows: float, window: int, overlap: int,
                        embed_dim: int) -> tuple[float, float]:
    """(bytes, FLOPs) of softmax(q kᵀ + bias) v, forward and backward, over
    ``windows`` OCAB windows x groups: the bytes of the map, not of the
    overlapping windows (forward each token's q, k and v read once and
    the output written; backward q, k, v, the output and its gradient read
    and q, k and v's gradients written), so that a kernel reading the
    windows in place could reach 100 %; 4 window² overlap² embed_dim FLOPs
    a window forward (all heads), ``ATTN_BACKWARD_FACTOR`` times that
    backward."""
    tensor = window * window * embed_dim * F32_BYTES
    fwd = 4.0 * window * window * overlap * overlap * embed_dim
    return windows * (4 + 8) * tensor, windows * fwd * (1.0 + ATTN_BACKWARD_FACTOR)


def cab_work(blocks: float, h: int, w: int, embed_dim: int,
             compress_ratio: int) -> tuple[float, float]:
    """(bytes, FLOPs) of the CAB's two 3x3 convs, forward and backward, over
    ``blocks`` samples x CAB branches on an h x w map: their input,
    intermediate and output read or written once forward and once
    backward; the forward's FLOPs, and twice them backward (the data and
    the weight gradients)."""
    px, compressed = h * w, embed_dim // compress_ratio
    fwd = 2.0 * 2 * px * 9 * embed_dim * compressed
    return blocks * 2 * (2 * embed_dim + compressed) * px * F32_BYTES, blocks * 3 * fwd
