"""The yardstick of SwinIR's cells: the FLOPs of one forward and the bytes
and FLOPs of the window attention, from the configuration's widths alone,
so that a change to the program cannot move them."""

from __future__ import annotations

import math

from benchmark.harness.yardstick import PEAK_F32_FLOPS_PER_S, PEAK_HBM_BYTES_PER_S

# the backward of softmax(q kᵀ) v against its forward: dV, dP, dQ and dK are
# four products of the forward's two, and a kernel that keeps no scores
# recomputes q kᵀ
ATTN_BACKWARD_FACTOR = 2.5
F32_BYTES = 4


def swinir_forward_flops(p: dict, h: int, w: int) -> float:
    """FLOPs (2 x multiply-adds) of one SwinIR forward on an h x w LR grid
    (padded to the window, as the network pads it): every Linear, the two
    attention products (q kᵀ, attn v) and every conv. Norms, softmax, GELU,
    biases and adds are left out."""
    win = p["window_size"]
    h, w = h + (-h) % win, w + (-w) % win
    e, nf, r = p["embed_dim"], p["num_feat"], p["upscale"]
    hidden = int(e * p["mlp_ratio"])
    px = h * w
    per_token = 3 * e * e + 2 * win * win * e + e * e + 2 * e * hidden
    macs = px * sum(p["depths"]) * per_token
    macs += px * 9 * e * e * len(p["depths"])                       # each group's conv
    macs += px * 9 * (p["in_chans"] * e + e * e + e * nf)           # first, after body, before up
    for _ in range(int(math.log2(r))):                              # conv nf -> 4 nf, shuffle x2
        macs += px * 9 * nf * 4 * nf
        px *= 4
    macs += px * 9 * nf                                             # conv_last, nf -> 1
    return 2.0 * macs


def window_attention_work(windows: float, window: int, embed_dim: int) -> tuple[float, float]:
    """(bytes, FLOPs) of softmax(q kᵀ + bias) v, forward and backward, over
    ``windows`` windows x Swin layers of window² tokens: forward q, k, v
    read and the output written; backward q, k, v, the output and its
    gradient read and q, k and v's gradients written; 4 window² embed_dim
    FLOPs a window forward (all heads), ``ATTN_BACKWARD_FACTOR`` times that
    backward."""
    n = window * window
    tensor = n * embed_dim * F32_BYTES
    fwd = 4.0 * n * n * embed_dim
    return windows * (4 + 8) * tensor, windows * fwd * (1.0 + ATTN_BACKWARD_FACTOR)


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of bytes over HBM bandwidth and FLOPs over the float32 peak."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS_PER_S)
