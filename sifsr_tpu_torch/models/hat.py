"""HAT, the Hybrid Attention Transformer (Chen, Wang, Zhou, Qiao and Dong,
"Activating More Pixels in Image Super-Resolution Transformer", CVPR 2023,
arXiv:2205.04437), as a network of the scale-invariance-free training
recipes.

The equations are those of ``hat/archs/hat_arch.py`` in
github.com/XPixelGroup/HAT with ``upsampler='pixelshuffle'`` and
``resi_connection='1conv'``. Head and tail are SwinIR's (``models.swinir``):

    x0 = conv_first(pixel_unshuffle(x, 4)),  t = LN(flatten(x0))
    t  = RHAG_k(t), k = 1..len(depths)
    y  = conv_last(up(LeakyReLU_0.01(conv_before_upsample(conv_after_body(unflatten(LN(t))) + x0))))

Tokens ``t`` are (B, HW, C); ``u = LN1(t)`` viewed as (B, H, W, C):

    RHAG(t) = t + flatten(conv3x3(unflatten(OCAB(HAB_d(...HAB_1(t))))))
    HAB:    t <- t + W-MSA(u) + conv_scale CAB(u),   then t <- t + MLP(LN2(t))
    CAB(u)  = y * sigmoid(W2 ReLU(W1 mean_HW(y) + b1) + b2),  y = conv3x3(GELU(conv3x3(u)))
    OCAB:   [q|k|v] = LN1(t) W_qkv + b_qkv
            t <- t + proj(softmax(scale q kᵀ + B) v),   then t <- t + MLP(LN2(t))

W-MSA is SwinIR's window attention in windows of ``window_size``² tokens,
on every second HAB of a group after ``roll(-window_size // 2)`` and under
the -100 region mask, with Swin's ``(2 w - 1)², heads`` bias table and the
scale ``head_dim ** -0.5`` applied to q. The CAB maps C -> C /
``compress_ratio`` -> C through 3x3 convs, and its gate C -> C /
``squeeze_factor`` -> C through 1x1 convs on the per-sample mean.

In the OCAB the queries are the ``window_size``² windows of q; the keys and
values of a window are the o² window (o = window_size (1 +
``overlap_ratio``)) centred on it, cut from k and v zero-padded by (o -
window_size) / 2 on every side of the map: border keys and values are
zeros, not masked out. No shift, no mask. ``B`` is gathered from a
``(window_size + o - 1)², heads`` table by the offset between a key's
place in its o² window and a query's in its window, in the row order of
``hat_arch.py``'s ``calculate_rpi_oca`` (``overlap_position_index``).

Departures from the published classical-SR model are SwinIR's
(``models.swinir``): the 2 guide channels enter as ``pixel_unshuffle(x,
4)`` (``in_chans`` 32), one output channel, no stochastic depth.
``img_range`` 1 with a zero mean is the identity. An LR grid that is not a
multiple of the window is reflect-padded on its bottom and right, and the
output cropped, as HAT's model wrapper pads its inputs.

Under ``tracing`` each HAB's attention opens ``swin.attention`` (and counts
into ``swin_windows``) as SwinIR's layers do; each OCAB attention, forward
and backward, opens ``hat.ocab_attention`` and adds its windows to
``ocab_windows``; each CAB branch, forward and backward, opens ``hat.cab``
and adds its samples to ``cab_blocks``. The CAB's backward lies in one
range because the branch is one node of the outer graph (``_BranchFn``),
whose backward runs autograd over the branch's own graph: the same
operations and gradients as autograd's.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sifsr_tpu_torch import tracing
from sifsr_tpu_torch.models.swinir import (
    LN_EPS,
    Mlp,
    SwinIR,
    WindowAttention,
    WindowAttentionFn,
    window_partition,
    window_reverse,
)

__all__ = ["HAT", "overlap_position_index"]


def overlap_position_index(window: int, overlap: int) -> torch.Tensor:
    """(window², overlap²) rows of the OCAB's ``(window + overlap - 1)²``
    bias table, for a query at (yq, xq) of its window and a key at (yk, xk)
    of its overlapping window: ``calculate_rpi_oca``'s
    (dy + window - overlap + 1) (window + overlap - 1) + dx + window -
    overlap + 1, (dy, dx) = (yk - yq, xk - xq), whose negative values
    ``hat_arch.py``'s indexing wraps; here they are wrapped explicitly."""
    side = window + overlap - 1
    d = torch.arange(overlap)[None, :] - torch.arange(window)[:, None] + window - overlap + 1
    rows = d[:, None, :, None] * side + d[None, :, None, :]
    return (rows % (side * side)).reshape(window * window, overlap * overlap)


class _BranchFn(torch.autograd.Function):
    """``fn(x)`` as one node of the outer graph, its forward and backward
    each in a ``name`` span; ``params`` are the parameters ``fn`` reads. The
    forward builds ``fn``'s own graph from a detached input and the
    parameters; the backward runs autograd over that graph. Same
    operations, same gradients."""

    @staticmethod
    def forward(ctx, x, fn, name: str, *params):
        with tracing.span(name), torch.enable_grad():
            leaf = x.detach().requires_grad_(ctx.needs_input_grad[0])
            out = fn(leaf)
        ctx.graph, ctx.name = (leaf, out, params), name
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        leaf, out, params = ctx.graph
        del ctx.graph
        wanted = [t for t, need in zip((leaf, *params),
                                       ctx.needs_input_grad[:1] + ctx.needs_input_grad[3:])
                  if need]
        with tracing.span(ctx.name):
            got = iter(torch.autograd.grad(out, wanted, grad))
        grads = [next(got) if need else None
                 for need in ctx.needs_input_grad[:1] + ctx.needs_input_grad[3:]]
        return grads[0], None, None, *grads[1:]


class _ChannelAttention(nn.Module):
    """x * sigmoid(W2 ReLU(W1 mean_HW(x) + b1) + b2), per sample."""

    def __init__(self, dim: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                       nn.Conv2d(dim, dim // squeeze_factor, 1),
                                       nn.ReLU(),
                                       nn.Conv2d(dim // squeeze_factor, dim, 1),
                                       nn.Sigmoid())

    def forward(self, x):
        return x * self.attention(x)


class _CAB(nn.Module):
    """The channel-attention conv branch on a (B, H, W, C) map; its convs
    read and write the map channels-last."""

    def __init__(self, dim: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        self.cab = nn.Sequential(nn.Conv2d(dim, dim // compress_ratio, 3, 1, 1),
                                 nn.GELU(),
                                 nn.Conv2d(dim // compress_ratio, dim, 3, 1, 1),
                                 _ChannelAttention(dim, squeeze_factor))

    def _branch(self, u):
        return self.cab(u.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, u):
        tracing.count("cab_blocks", u.shape[0])
        if not torch.is_grad_enabled():
            with tracing.span("hat.cab"):
                return self._branch(u)
        return _BranchFn.apply(u, self._branch, "hat.cab", *self.parameters())


class _HAB(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, compress_ratio: int,
                 squeeze_factor: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.window, self.shift, self.conv_scale = window, shift, conv_scale
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, heads)
        self.conv_block = _CAB(dim, compress_ratio, squeeze_factor)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, hw: tuple[int, int], mask):
        h, w = hw
        b, _, c = x.shape
        u = self.norm1(x).view(b, h, w, c)
        conv = self.conv_block(u).reshape(b, h * w, c)
        y = torch.roll(u, shifts=(-self.shift, -self.shift), dims=(1, 2)) if self.shift else u
        y = self.attn(window_partition(y, self.window), mask if self.shift else None)
        y = window_reverse(y, self.window, b, h, w)
        if self.shift:
            y = torch.roll(y, shifts=(self.shift, self.shift), dims=(1, 2))
        x = x + y.reshape(b, h * w, c) + conv * self.conv_scale
        return x + self.mlp(self.norm2(x))


class _OCAB(nn.Module):
    def __init__(self, dim: int, window: int, overlap_ratio: float, heads: int,
                 mlp_ratio: float):
        super().__init__()
        self.window, self.heads, self.scale = window, heads, (dim // heads) ** -0.5
        self.overlap = int(window * overlap_ratio) + window
        if (self.overlap - window) % 2:
            raise ValueError(f"an overlapping window of {self.overlap} is not centred on "
                             f"a window of {window}")
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window + self.overlap - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             overlap_position_index(window, self.overlap).flatten(),
                             persistent=False)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, hw: tuple[int, int]):
        h, w = hw
        b, _, c = x.shape
        win, ow = self.window, self.overlap
        pad = (ow - win) // 2
        qkv = self.qkv(self.norm1(x)).view(b, h, w, 3 * c)
        q = window_partition(qkv[..., :c], win)
        kv = F.pad(qkv[..., c:], (0, 0, pad, pad, pad, pad))
        kv = kv.unfold(1, ow, win).unfold(2, ow, win).permute(0, 1, 2, 4, 5, 3)
        kv = kv.reshape(q.shape[0], ow * ow, 2 * c)
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.view(win * win, ow * ow, -1).permute(2, 0, 1)
        tracing.count("ocab_windows", q.shape[0])
        y = WindowAttentionFn.apply(q, kv, bias, None, self.heads, self.scale,
                                    "hat.ocab_attention")
        x = x + self.proj(window_reverse(y, win, b, h, w).reshape(b, h * w, c))
        return x + self.mlp(self.norm2(x))


class _RHAG(nn.Module):
    """HABs (every second one shifted), an OCAB and a 3x3 conv, with the
    group's residual."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, compress_ratio: int,
                 squeeze_factor: int, conv_scale: float, overlap_ratio: float,
                 mlp_ratio: float):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            _HAB(dim, heads, window, 0 if i % 2 == 0 else window // 2, compress_ratio,
                 squeeze_factor, conv_scale, mlp_ratio)
            for i in range(depth))
        self.residual_group.overlap_attn = _OCAB(dim, window, overlap_ratio, heads, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, hw, mask):
        y = x
        for blk in self.residual_group.blocks:
            y = blk(y, hw, mask)
        y = self.residual_group.overlap_attn(y, hw)
        b, _, c = x.shape
        y = self.conv(y.transpose(1, 2).view(b, c, *hw))
        return y.flatten(2).transpose(1, 2) + x


class HAT(SwinIR):
    """HAT with the pixel-shuffle upsampler, NHWC (N, H, W, 2) -> (N, H, W,
    1) float32 (module docstring): SwinIR's head, tail, padding and
    initialisation around residual hybrid attention groups, built by
    SwinIR's constructor with no group and then given HAT's. State-dict
    keys follow ``hat_arch.py`` (``layers.i.residual_group.blocks.j.{norm1,
    attn,conv_block.cab.{0,2},conv_block.cab.3.attention.{1,3},norm2,mlp}``,
    ``layers.i.residual_group.overlap_attn.{relative_position_bias_table,
    norm1,qkv,proj,norm2,mlp}``, ``layers.i.conv`` and SwinIR's head and tail
    keys); the relative position indices and the shift mask are not in
    it."""

    def __init__(self, upscale: int = 4, in_chans: int = 32, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), window_size: int = 16,
                 compress_ratio: int = 3, squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0, num_feat: int = 64,
                 precision: str = "highest"):
        super().__init__(upscale, in_chans, embed_dim, (), (), window_size, mlp_ratio, num_feat,
                         precision)
        if len(depths) != len(num_heads) or any(embed_dim % h for h in num_heads):
            raise ValueError(f"embed_dim {embed_dim} over heads {tuple(num_heads)}")
        if embed_dim % compress_ratio or embed_dim % squeeze_factor:
            raise ValueError(f"embed_dim {embed_dim} over compress_ratio {compress_ratio} or "
                             f"squeeze_factor {squeeze_factor}")
        self.depths = tuple(depths)
        self.layers.extend(
            _RHAG(embed_dim, d, h, window_size, compress_ratio, squeeze_factor, conv_scale,
                  overlap_ratio, mlp_ratio)
            for d, h in zip(depths, num_heads))
