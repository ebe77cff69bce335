"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
ICCV Workshops 2021, arXiv:2108.10257) as a network of the
scale-invariance-free training recipes.

The equations are those of ``models/network_swinir.py`` in
github.com/JingyunLiang/SwinIR with ``upsampler='pixelshuffle'`` and
``resi_connection='1conv'``:

    x0   = conv_first(x)                                3x3, in_chans -> embed_dim
    t    = LN(flatten(x0))                              patch_norm
    t    = RSTB_k(t), k = 1..len(depths)                t + conv3x3(SwinLayers(t))
    f    = conv_after_body(unflatten(LN(t))) + x0
    y    = conv_last(up(LeakyReLU_0.01(conv_before_upsample(f))))
    up   = [conv num_feat -> 4 num_feat, PixelShuffle(2)] x log2(upscale)

A Swin layer is ``t + attn(LN(t))`` then ``t + fc2(GELU(fc1(LN(t))))``; the
attention runs in windows of ``window_size``² tokens, on every second layer
of a group after ``roll(-window_size // 2)`` and under the -100 region mask,
with scale ``head_dim ** -0.5`` applied to q and Swin's learned relative
position bias (a ``(2 w - 1)², heads`` table gathered per window).

Departures from the published classical-SR model, for this system's data:

- ``forward`` keeps ModelB_2's contract: NHWC ``(N, 4h, 4w, 2)`` (the cubic
  x4 LST and the 250 m NDVI, normalised) in, ``(N, 4h, 4w, 1)`` out. The
  network's input is ``pixel_unshuffle(x, 4)``: 32 channels at the LR grid,
  so the guidance enters every LR token as its 4x4 sub-pixels
  (``in_chans`` 32, published 3).
- One output channel (``num_out_ch`` 1).
- No stochastic depth (``drop_path_rate`` 0, the class default 0.1): it
  changes no shape or FLOP, and would tie each step to an RNG stream.

``img_range`` is 1 and the mean is zero for a channel count other than 3,
as in the published code, so the input and output affine maps are the
identity and are left out. An LR grid that is not a multiple of the window
is reflect-padded on its bottom and right, and the output cropped, as
``check_image_size`` does.

The window attention is ``WindowAttentionFn``: batched float32 matmuls and
a softmax, with a backward of its own that writes q, k and v's gradients
into one buffer. Under ``tracing`` each call, forward and backward, is a
``swin.attention`` span, and each forward adds the counters ``tokens`` (LR
tokens) and ``swin_windows`` (windows x Swin layers run) to the open root.

``models.hat`` builds HAT on this module's window helpers, its window
attention and its head and tail; ``WindowAttentionFn`` also takes queries
against keys and values of another token count (HAT's overlapping
cross-attention), under a span its caller names.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sifsr_tpu_torch import tracing

__all__ = ["SwinIR", "WindowAttention", "WindowAttentionFn", "Mlp", "LN_EPS",
           "relative_position_index", "shift_mask", "window_partition", "window_reverse"]

MASK_VALUE = -100.0          # network_swinir.py's additive region mask
LEAKY_SLOPE = 0.01           # nn.LeakyReLU's default, as published
LN_EPS = 1e-5


def relative_position_index(window: int) -> torch.Tensor:
    """Swin's (w², w²) index into the bias table: (dy + w - 1) (2w - 1) +
    dx + w - 1 for the offset (dy, dx) between two tokens of a window."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window², C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, b: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shift_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """(nW, window², window²) additive mask of a shifted layer: 0 between two
    tokens of one region of the rolled map, -100 across regions."""
    img = torch.zeros((1, h, w, 1))
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    region = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = region
            region += 1
    ids = window_partition(img, window)[..., 0]
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.zeros_like(diff).masked_fill_(diff != 0, MASK_VALUE)


def _heads(q: torch.Tensor, kv: torch.Tensor | None, heads: int):
    """(q, k, v), each (B_, heads, tokens, head_dim): views of a packed
    (B_, N, 3 C) q | k | v (``kv`` None), or of (B_, Nq, C) queries and
    (B_, Nk, 2 C) k | v."""
    if kv is None:
        b_, n, c3 = q.shape
        return q.view(b_, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)
    b_, nq, c = q.shape
    k, v = kv.view(b_, kv.shape[1], 2, heads, c // heads).permute(2, 0, 3, 1, 4)
    return q.view(b_, nq, heads, c // heads).transpose(1, 2), k, v


class WindowAttentionFn(torch.autograd.Function):
    """softmax((scale q) kᵀ + bias [+ mask]) v in every window and head.
    ``q``: the qkv projection's output (B_, N, 3 C), q | k | v, with ``kv``
    None; or queries (B_, Nq, C) and ``kv`` (B_, Nk, 2 C), k | v. Each part
    is heads x head_dim wide. ``bias``: (heads, Nq, Nk); ``mask``: (nW, Nq,
    Nk) or None, B_ a multiple of nW. Returns (B_, Nq, C), heads
    concatenated. Forward and backward are each a ``name`` span. The scores'
    softmax is kept for the backward, which writes q, k and v's gradients
    into one buffer for a packed input, into two otherwise."""

    @staticmethod
    def forward(ctx, q, kv, bias, mask, heads: int, scale: float, name: str = "swin.attention"):
        with tracing.span(name):
            qh, k, v = _heads(q, kv, heads)
            b_, _, nq, d = qh.shape
            nk = k.shape[2]
            qh = qh * scale
            attn = torch.matmul(qh, k.transpose(-2, -1))
            attn += bias
            if mask is not None:
                nw = mask.shape[0]
                attn.view(b_ // nw, nw, heads, nq, nk).add_(mask[None, :, None])
            attn = torch.softmax(attn, dim=-1)
            out = torch.matmul(attn, v)
            ctx.save_for_backward(q, kv, attn)
            ctx.heads, ctx.scale, ctx.name = heads, scale, name
            return out.transpose(1, 2).reshape(b_, nq, heads * d)

    @staticmethod
    def backward(ctx, dout):
        with tracing.span(ctx.name):
            q, kv, attn = ctx.saved_tensors
            heads, scale = ctx.heads, ctx.scale
            qh, k, v = _heads(q, kv, heads)
            b_, _, nq, d = qh.shape
            do = dout.reshape(b_, nq, heads, d).transpose(1, 2)
            if kv is None:
                dqkv = q.new_empty(b_, nq, 3, heads, d)
                dq, dk, dv = dqkv.permute(2, 0, 3, 1, 4)
            else:
                dqs = q.new_empty(b_, nq, heads, d)
                dkv = kv.new_empty(b_, kv.shape[1], 2, heads, d)
                dq = dqs.transpose(1, 2)
                dk, dv = dkv.permute(2, 0, 3, 1, 4)
            dv.copy_(torch.matmul(attn.transpose(-2, -1), do))
            dp = torch.matmul(do, v.transpose(-2, -1))
            ds = attn * (dp - (dp * attn).sum(-1, keepdim=True))
            dbias = ds.sum(0) if ctx.needs_input_grad[2] else None
            dq.copy_(torch.matmul(ds, k)).mul_(scale)
            dk.copy_(torch.matmul(ds.transpose(-2, -1), qh * scale))
            if kv is None:
                return dqkv.view(b_, nq, -1), None, dbias, None, None, None, None
            return (dqs.view(b_, nq, -1), dkv.view(b_, kv.shape[1], -1), dbias, None, None,
                    None, None)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.heads, self.scale = heads, (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window).flatten(), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask):
        n = x.shape[1]
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.view(n, n, -1).permute(2, 0, 1)
        return self.proj(WindowAttentionFn.apply(self.qkv(x), None, bias, mask, self.heads,
                                                 self.scale))


class _SwinLayer(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, hw: tuple[int, int], mask):
        h, w = hw
        b, _, c = x.shape
        y = self.norm1(x).view(b, h, w, c)
        if self.shift:
            y = torch.roll(y, shifts=(-self.shift, -self.shift), dims=(1, 2))
        y = self.attn(window_partition(y, self.window), mask if self.shift else None)
        y = window_reverse(y, self.window, b, h, w)
        if self.shift:
            y = torch.roll(y, shifts=(self.shift, self.shift), dims=(1, 2))
        x = x + y.reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class _ResidualGroup(nn.Module):
    """A BasicLayer (``residual_group``: Swin layers, every second one
    shifted) and its 3x3 conv, with the group's residual (RSTB)."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            _SwinLayer(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x, hw, mask):
        y = x
        for blk in self.residual_group.blocks:
            y = blk(y, hw, mask)
        b, _, c = x.shape
        y = self.conv(y.transpose(1, 2).view(b, c, *hw))
        return y.flatten(2).transpose(1, 2) + x


class SwinIR(nn.Module):
    """SwinIR with the pixel-shuffle upsampler, NHWC (N, H, W, 2) ->
    (N, H, W, 1) float32 (module docstring). State-dict keys follow
    ``network_swinir.py`` (``conv_first``, ``patch_embed.norm``,
    ``layers.i.residual_group.blocks.j.{norm1,attn,norm2,mlp}``,
    ``layers.i.conv``, ``norm``, ``conv_after_body``,
    ``conv_before_upsample.0``, ``upsample.{0,2}``, ``conv_last``); the
    relative position index and the shift mask are not in it."""

    def __init__(self, upscale: int = 4, in_chans: int = 32, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6), window_size: int = 8,
                 mlp_ratio: float = 2.0, num_feat: int = 64, precision: str = "highest"):
        super().__init__()
        if precision not in ("highest", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        if upscale & (upscale - 1) or upscale < 2:
            raise ValueError(f"upscale must be a power of two, got {upscale}")
        if len(depths) != len(num_heads) or any(embed_dim % h for h in num_heads):
            raise ValueError(f"embed_dim {embed_dim} over heads {tuple(num_heads)}")
        self.precision = precision
        self.upscale, self.window = upscale, window_size
        self.depths = tuple(depths)
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.layers = nn.ModuleList(
            _ResidualGroup(embed_dim, d, h, window_size, mlp_ratio)
            for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                                                  nn.LeakyReLU(LEAKY_SLOPE))
        up = []
        for _ in range(int(math.log2(upscale))):
            up += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*up)
        self.conv_last = nn.Conv2d(num_feat, 1, 3, 1, 1)
        self._masks: dict = {}

    def init_parameters(self, generator: torch.Generator) -> None:
        """SwinIR's initialisation, drawn on the CPU from ``generator`` in
        the modules' order: Linear weights and the bias tables a normal of
        std 0.02 truncated at +-2 (timm's ``trunc_normal_``), Linear biases
        zero, LayerNorm 1 / 0, convs PyTorch's default (weight and bias
        uniform in +-1/sqrt(fan_in))."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.copy_(_trunc_normal(m.weight.shape, generator))
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, nn.Conv2d):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    for p in (m.weight, m.bias):
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                              generator=generator))
                elif isinstance(getattr(m, "relative_position_bias_table", None),
                                nn.Parameter):
                    t = m.relative_position_bias_table
                    t.copy_(_trunc_normal(t.shape, generator))

    def _mask(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, device)
        if key not in self._masks:
            self._masks[key] = shift_mask(h, w, self.window, self.window // 2).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        if remat:
            raise ValueError(f"{type(self).__name__} has no rematerialisation (remat is a "
                             "ModelB_2 option)")
        n, hh, ww, _ = x.shape
        r, win = self.upscale, self.window
        x = F.pixel_unshuffle(x.permute(0, 3, 1, 2), r)
        h, w = x.shape[-2:]
        ph, pw = (-h) % win, (-w) % win
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            h, w = h + ph, w + pw
        if min(h, w) <= win:
            raise ValueError(f"an LR grid of {h}x{w} holds no shifted {win}² window")
        tracing.count("tokens", n * h * w)
        tracing.count("swin_windows", n * (h // win) * (w // win) * sum(self.depths))
        x = self.conv_first(x)
        c = x.shape[1]
        t = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        mask = self._mask(h, w, x.device)
        for layer in self.layers:
            t = layer(t, (h, w), mask)
        t = self.norm(t).transpose(1, 2).view(n, c, h, w)
        x = self.conv_after_body(t) + x
        y = self.conv_last(self.upsample(self.conv_before_upsample(x)))
        return y[:, :, :hh, :ww].permute(0, 2, 3, 1)


def _trunc_normal(shape, generator) -> torch.Tensor:
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, std=0.02, a=-2.0, b=2.0, generator=generator)
    return w
