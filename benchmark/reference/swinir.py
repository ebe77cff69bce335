"""The plain reference of SwinIR-M x4 in the scale-invariance-free training
recipe, in float32 with TF32 off.

The forward is written out from the equations of ``models/network_swinir.py``
(github.com/JingyunLiang/SwinIR; ``upsampler='pixelshuffle'``,
``resi_connection='1conv'``, ``patch_norm``, no absolute position
embedding), on a dict of parameters named as that module's state dict:

    x0 = conv_first(pixel_unshuffle(x, upscale))
    t  = LN(tokens(x0)); t = t + tokens(conv(unflatten(L_d(...L_1(t))))) per group
    x1 = conv_after_body(unflatten(LN(t))) + x0
    y  = conv_last([PixelShuffle(2) . conv]^log2(upscale) (LeakyReLU(conv_before_upsample(x1))))

    L(t) = t' + fc2(GELU(fc1(LN(t')))),  t' = t + reverse(proj(WA(partition(roll(LN(t))))))
    WA   = softmax((q * head_dim^-1/2) kᵀ + B[rel] + M) v   per window and head

with the roll of -window/2 (and back) and the -100 region mask M on every
second layer of a group. The departures of the benchmark's configuration
(``configs/swinirM-x4-f32.json``, ``assumed``): the 2-channel input (cubic
x4 LST, NDVI) enters as its 4x4 sub-pixels (32 channels), one output
channel, no stochastic depth; ``img_range`` 1 with a zero mean is the
identity. Every product goes through ``Ops``, so that the control (a lower
precision) is this same code with other ``Ops``.

``train_steps`` is one ``predef_filters`` step a batch from a state dict:
this forward, ``train.py``'s ``loss_predef`` (kernel M's chain and the
Sobel loss, written out there) and Adam written out (torch's rule).
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.modelb2 import bicubic_x4, full_f32
from benchmark.reference.train import loss_predef

LN_EPS = 1e-5


class Ops:
    """Every product of the network, in full float32."""

    def linear(self, x, w, b):
        return F.linear(x, w, b)

    def matmul(self, a, b):
        return torch.matmul(a, b)

    def conv(self, x, w, b):
        return F.conv2d(x, w, b, padding=1)


def param_plan(p: dict) -> list[tuple[str, tuple, str]]:
    """[(state-dict key, shape, kind)] in the network's order; kinds
    ``conv_w``, ``conv_b``, ``linear_w``, ``linear_b``, ``ln_w``, ``ln_b``,
    ``table``."""
    e, win, nf, r = p["embed_dim"], p["window_size"], p["num_feat"], p["upscale"]
    hidden = int(e * p["mlp_ratio"])
    out = []

    def conv(key, ci, co):
        out.extend([(f"{key}.weight", (co, ci, 3, 3), "conv_w"), (f"{key}.bias", (co,), "conv_b")])

    def linear(key, ci, co):
        out.extend([(f"{key}.weight", (co, ci), "linear_w"), (f"{key}.bias", (co,), "linear_b")])

    def ln(key):
        out.extend([(f"{key}.weight", (e,), "ln_w"), (f"{key}.bias", (e,), "ln_b")])

    conv("conv_first", p["in_chans"], e)
    ln("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(p["depths"], p["num_heads"])):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            ln(f"{b}.norm1")
            out.append((f"{b}.attn.relative_position_bias_table", ((2 * win - 1) ** 2, heads),
                        "table"))
            linear(f"{b}.attn.qkv", e, 3 * e)
            linear(f"{b}.attn.proj", e, e)
            ln(f"{b}.norm2")
            linear(f"{b}.mlp.fc1", e, hidden)
            linear(f"{b}.mlp.fc2", hidden, e)
        conv(f"layers.{i}.conv", e, e)
    ln("norm")
    conv("conv_after_body", e, e)
    conv("conv_before_upsample.0", e, nf)
    for k in range(int(math.log2(r))):
        conv(f"upsample.{2 * k}", nf, 4 * nf)
    conv("conv_last", nf, 1)
    return out


def rel_index(win: int) -> torch.Tensor:
    """(win², win²): the bias table's row for tokens i, j of a window,
    (yi - yj + win - 1) (2 win - 1) + xi - xj + win - 1."""
    i = torch.arange(win * win)
    y, x = i // win, i % win
    return (y[:, None] - y[None, :] + win - 1) * (2 * win - 1) + x[:, None] - x[None, :] + win - 1


def region_mask(h: int, w: int, win: int, shift: int) -> torch.Tensor:
    """(nW, win², win²): 0 where two tokens of a window of the rolled map
    lie in one of its 3x3 regions (bands [0, n - win), [n - win, n - shift),
    [n - shift, n) of each axis), -100 elsewhere."""
    def band(n):
        v = torch.arange(n)
        return (v >= n - win).long() + (v >= n - shift).long()

    ids = band(h)[:, None] * 3 + band(w)[None, :]
    ids = ids.reshape(h // win, win, w // win, win).permute(0, 2, 1, 3).reshape(-1, win * win)
    return torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0)


def _windows(x, win):
    """(n, h, w, c) -> (n * nW, win², c), windows in row-major order."""
    n, h, w, c = x.shape
    return x.reshape(n, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(-1, win * win, c)


def _unwindows(y, win, n, h, w):
    c = y.shape[-1]
    return y.reshape(n, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, h, w, c)


def _ln(t, sd, key):
    return F.layer_norm(t, (t.shape[-1],), sd[f"{key}.weight"], sd[f"{key}.bias"], LN_EPS)


def swin_layer(t, sd, key, hw, heads, win, shift, ops: Ops):
    """One Swin layer on tokens (n, h w, c)."""
    n, length, c = t.shape
    h, w = hw
    x = _ln(t, sd, f"{key}.norm1").reshape(n, h, w, c)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = _windows(x, win)
    b_, tokens = x.shape[:2]
    qkv = ops.linear(x, sd[f"{key}.attn.qkv.weight"], sd[f"{key}.attn.qkv.bias"])
    qkv = qkv.reshape(b_, tokens, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = ops.matmul(q, k.transpose(-2, -1))
    table = sd[f"{key}.attn.relative_position_bias_table"]
    bias = table[rel_index(win).to(table.device).reshape(-1)].reshape(tokens, tokens, heads)
    attn = attn + bias.permute(2, 0, 1)[None]
    if shift:
        m = region_mask(h, w, win, shift).to(attn.device)
        attn = (attn.reshape(-1, m.shape[0], heads, tokens, tokens) + m[None, :, None]) \
            .reshape(b_, heads, tokens, tokens)
    attn = torch.softmax(attn, dim=-1)
    y = ops.matmul(attn, v).transpose(1, 2).reshape(b_, tokens, c)
    y = ops.linear(y, sd[f"{key}.attn.proj.weight"], sd[f"{key}.attn.proj.bias"])
    y = _unwindows(y, win, n, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    t = t + y.reshape(n, length, c)
    u = ops.linear(_ln(t, sd, f"{key}.norm2"), sd[f"{key}.mlp.fc1.weight"],
                   sd[f"{key}.mlp.fc1.bias"])
    u = ops.linear(F.gelu(u), sd[f"{key}.mlp.fc2.weight"], sd[f"{key}.mlp.fc2.bias"])
    return t + u


def forward(sd: dict, x: torch.Tensor, p: dict, ops: Ops | None = None) -> torch.Tensor:
    """(N, 2, H, W) -> (N, 1, H, W) under ``ops`` (full float32 by default)."""
    ops = ops or Ops()
    r, win = p["upscale"], p["window_size"]

    def conv(x, key):
        return ops.conv(x, sd[f"{key}.weight"], sd[f"{key}.bias"])

    with full_f32():
        hh, ww = x.shape[-2:]
        x = F.pixel_unshuffle(x, r)
        h, w = x.shape[-2:]
        ph, pw = (-h) % win, (-w) % win           # check_image_size
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            h, w = h + ph, w + pw
        x = conv(x, "conv_first")
        n, c = x.shape[:2]
        t = _ln(x.flatten(2).transpose(1, 2), sd, "patch_embed.norm")
        for i, (depth, heads) in enumerate(zip(p["depths"], p["num_heads"])):
            y = t
            for j in range(depth):
                y = swin_layer(y, sd, f"layers.{i}.residual_group.blocks.{j}", (h, w), heads,
                               win, 0 if j % 2 == 0 else win // 2, ops)
            y = conv(y.transpose(1, 2).reshape(n, c, h, w), f"layers.{i}.conv")
            t = y.flatten(2).transpose(1, 2) + t
        t = _ln(t, sd, "norm").transpose(1, 2).reshape(n, c, h, w)
        x = conv(t, "conv_after_body") + x
        x = F.leaky_relu(conv(x, "conv_before_upsample.0"), 0.01)
        for k in range(int(math.log2(r))):
            x = F.pixel_shuffle(conv(x, f"upsample.{2 * k}"), 2)
        return conv(x, "conv_last")[:, :, :hh, :ww]


def train_steps(sd0: dict, batches: list, p: dict, train_cfg: dict, stats: dict, device,
                ops: Ops | None = None):
    """One ``predef_filters`` step a batch from ``sd0``. Returns (losses, the
    first step's gradients, the parameters after the last step)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    (b1, b2), eps = train_cfg["adam"]["betas"], train_cfg["adam"]["eps"]
    lr = train_cfg["learning_rate"]
    losses, grad1 = [], None
    for t, batch in enumerate(batches, 1):
        lst = torch.as_tensor(batch["lst"], device=device).movedim(-1, 1)
        ndvi = torch.as_tensor(batch["ndvi"], device=device).movedim(-1, 1)
        with full_f32():
            x = torch.cat([bicubic_x4(lst), ndvi], dim=1)
            sr = forward(params, x, p, ops)
            loss = loss_predef(sr, lst, ndvi, train_cfg["alpha"], train_cfg["gamma"], stats)
            grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        del sr, loss
        with torch.no_grad():
            if t == 1:
                grad1 = {k: g.clone() for k, g in zip(params, grads)}
            for (k, w), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                w.sub_(lr / (1 - b1 ** t) * m[k] / denom)
        del grads
    return losses, grad1, {k: w.detach() for k, w in params.items()}
