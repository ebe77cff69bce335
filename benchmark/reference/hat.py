"""The plain reference of HAT x4 (``HAT_SRx4``) in the scale-invariance-free
training recipe, in float32 with TF32 off.

The forward is written out from the equations of ``hat/archs/hat_arch.py``
(github.com/XPixelGroup/HAT; ``upsampler='pixelshuffle'``,
``resi_connection='1conv'``, ``patch_norm``, no absolute position
embedding), on a dict of parameters named as that module's state dict:

    x0 = conv_first(pixel_unshuffle(x, upscale))
    t  = LN(tokens(x0)); t = t + tokens(conv(unflatten(OCAB(HAB_d(...HAB_1(t)))))) per group
    x1 = conv_after_body(unflatten(LN(t))) + x0
    y  = conv_last([PixelShuffle(2) . conv]^log2(upscale) (LeakyReLU(conv_before_upsample(x1))))

    HAB(t)  = t' + fc2(GELU(fc1(LN(t')))),
              t' = t + reverse(proj(WA(partition(roll(u))))) + conv_scale CAB(u),  u = LN(t)
    WA      = softmax((q * head_dim^-1/2) kᵀ + B[rel] + M) v   per window and head
    CAB(u)  = y * sigmoid(conv1x1(ReLU(conv1x1(mean_HW(y))))),  y = conv3x3(GELU(conv3x3(u)))
    OCAB(t) = t' + fc2(GELU(fc1(LN(t')))),
              t' = t + reverse(proj(softmax((q * head_dim^-1/2) kᵀ + B[oca]) v))

with the roll of -window/2 (and back) and the -100 region mask M on every
second HAB of a group. In the OCAB, q is cut into window² windows and k and
v, padded with zeros by (o - window) / 2 on every side (``F.pad``), into
the o² windows centred on them (o = window (1 + overlap_ratio)), by a plain
gather; the table's rows are ``hat_arch.py``'s ``calculate_rpi_oca``, its
negative rows wrapped as torch's indexing wraps them. The departures of
the benchmark's configuration (``configs/hat-x4-f32.json``, ``assumed``)
are SwinIR's: the 2-channel input enters as its 4x4 sub-pixels (32
channels), one output channel, no stochastic depth; ``img_range`` 1 with a
zero mean is the identity. Every product goes through ``Ops``, so that the
control (a lower precision) is this same code with other ``Ops``.

``train_steps`` is one ``predef_filters`` step a batch from a state dict,
as ``reference/swinir.py``'s: this forward, ``train.py``'s ``loss_predef``
and Adam written out (torch's rule). Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import swinir
from benchmark.reference.modelb2 import bicubic_x4, full_f32
from benchmark.reference.train import loss_predef


class Ops(swinir.Ops):
    """Every product of the network, in full float32; ``conv1`` is a 1x1
    conv (the CAB's gate)."""

    def conv1(self, x, w, b):
        return F.conv2d(x, w, b)


def overlap(p: dict) -> int:
    """The side of an OCAB key/value window."""
    return int(p["window_size"] * p["overlap_ratio"]) + p["window_size"]


def param_plan(p: dict) -> list[tuple[str, tuple, str]]:
    """[(state-dict key, shape, kind)] in the network's order; kinds
    ``conv_w``, ``conv_b``, ``linear_w``, ``linear_b``, ``ln_w``, ``ln_b``,
    ``table``."""
    e, win, nf, r = p["embed_dim"], p["window_size"], p["num_feat"], p["upscale"]
    hidden, ow = int(e * p["mlp_ratio"]), overlap(p)
    out = []

    def conv(key, ci, co, k=3):
        out.extend([(f"{key}.weight", (co, ci, k, k), "conv_w"), (f"{key}.bias", (co,), "conv_b")])

    def linear(key, ci, co):
        out.extend([(f"{key}.weight", (co, ci), "linear_w"), (f"{key}.bias", (co,), "linear_b")])

    def ln(key):
        out.extend([(f"{key}.weight", (e,), "ln_w"), (f"{key}.bias", (e,), "ln_b")])

    def mlp(key):
        linear(f"{key}.fc1", e, hidden)
        linear(f"{key}.fc2", hidden, e)

    conv("conv_first", p["in_chans"], e)
    ln("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(p["depths"], p["num_heads"])):
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            b = f"{g}.blocks.{j}"
            ln(f"{b}.norm1")
            out.append((f"{b}.attn.relative_position_bias_table", ((2 * win - 1) ** 2, heads),
                        "table"))
            linear(f"{b}.attn.qkv", e, 3 * e)
            linear(f"{b}.attn.proj", e, e)
            squeezed, compressed = e // p["squeeze_factor"], e // p["compress_ratio"]
            conv(f"{b}.conv_block.cab.0", e, compressed)
            conv(f"{b}.conv_block.cab.2", compressed, e)
            conv(f"{b}.conv_block.cab.3.attention.1", e, squeezed, k=1)
            conv(f"{b}.conv_block.cab.3.attention.3", squeezed, e, k=1)
            ln(f"{b}.norm2")
            mlp(f"{b}.mlp")
        o = f"{g}.overlap_attn"
        out.append((f"{o}.relative_position_bias_table", ((win + ow - 1) ** 2, heads), "table"))
        ln(f"{o}.norm1")
        linear(f"{o}.qkv", e, 3 * e)
        linear(f"{o}.proj", e, e)
        ln(f"{o}.norm2")
        mlp(f"{o}.mlp")
        conv(f"layers.{i}.conv", e, e)
    ln("norm")
    conv("conv_after_body", e, e)
    conv("conv_before_upsample.0", e, nf)
    for k in range(int(math.log2(r))):
        conv(f"upsample.{2 * k}", nf, 4 * nf)
    conv("conv_last", nf, 1)
    return out


def oca_index(win: int, ow: int) -> torch.Tensor:
    """(win², ow²): the OCAB table's row for query i of a window and key j of
    its overlapping window, as ``calculate_rpi_oca`` builds it (key
    coordinates minus query coordinates, each shifted by win - ow + 1, the
    row (win + ow - 1) dy + dx), its negative rows wrapped."""
    side = win + ow - 1
    qy, qx = torch.meshgrid(torch.arange(win), torch.arange(win), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(ow), torch.arange(ow), indexing="ij")
    dy = ky.reshape(1, -1) - qy.reshape(-1, 1) + win - ow + 1
    dx = kx.reshape(1, -1) - qx.reshape(-1, 1) + win - ow + 1
    return (dy * side + dx) % (side * side)


def _attend(q, k, v, bias, heads, ops: Ops, mask=None):
    """softmax((q d^-1/2) kᵀ + bias [+ mask]) v; q (B_, Nq, c), k and v (B_,
    Nk, c), bias (Nq, Nk, heads), mask (nW, Nq, Nk)."""
    b_, nq, c = q.shape
    nk = k.shape[1]
    d = c // heads
    q = q.reshape(b_, nq, heads, d).transpose(1, 2) * d ** -0.5
    k = k.reshape(b_, nk, heads, d).transpose(1, 2)
    v = v.reshape(b_, nk, heads, d).transpose(1, 2)
    attn = ops.matmul(q, k.transpose(-2, -1)) + bias.permute(2, 0, 1)[None]
    if mask is not None:
        attn = (attn.reshape(-1, mask.shape[0], heads, nq, nk) + mask[None, :, None]) \
            .reshape(b_, heads, nq, nk)
    attn = torch.softmax(attn, dim=-1)
    return ops.matmul(attn, v).transpose(1, 2).reshape(b_, nq, c)


def _mlp(t, sd, key, ops: Ops):
    u = ops.linear(t, sd[f"{key}.fc1.weight"], sd[f"{key}.fc1.bias"])
    return ops.linear(F.gelu(u), sd[f"{key}.fc2.weight"], sd[f"{key}.fc2.bias"])


def cab(x, sd, key, ops: Ops):
    """The channel-attention branch on (n, c, h, w)."""
    y = F.gelu(ops.conv(x, sd[f"{key}.0.weight"], sd[f"{key}.0.bias"]))
    y = ops.conv(y, sd[f"{key}.2.weight"], sd[f"{key}.2.bias"])
    a = f"{key}.3.attention"
    s = F.relu(ops.conv1(y.mean((2, 3), keepdim=True), sd[f"{a}.1.weight"], sd[f"{a}.1.bias"]))
    return y * torch.sigmoid(ops.conv1(s, sd[f"{a}.3.weight"], sd[f"{a}.3.bias"]))


def hab(t, sd, key, hw, heads, win, shift, p, ops: Ops):
    """One hybrid attention block on tokens (n, h w, c)."""
    n, length, c = t.shape
    h, w = hw
    u = swinir._ln(t, sd, f"{key}.norm1").reshape(n, h, w, c)
    conv = cab(u.permute(0, 3, 1, 2), sd, f"{key}.conv_block.cab", ops)
    conv = conv.permute(0, 2, 3, 1).reshape(n, length, c)
    x = torch.roll(u, (-shift, -shift), (1, 2)) if shift else u
    x = swinir._windows(x, win)
    qkv = ops.linear(x, sd[f"{key}.attn.qkv.weight"], sd[f"{key}.attn.qkv.bias"])
    table = sd[f"{key}.attn.relative_position_bias_table"]
    bias = table[swinir.rel_index(win).to(table.device).reshape(-1)].reshape(win * win,
                                                                            win * win, heads)
    mask = swinir.region_mask(h, w, win, shift).to(t.device) if shift else None
    y = _attend(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias, heads, ops, mask)
    y = ops.linear(y, sd[f"{key}.attn.proj.weight"], sd[f"{key}.attn.proj.bias"])
    y = swinir._unwindows(y, win, n, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    t = t + y.reshape(n, length, c) + conv * p["conv_scale"]
    return t + _mlp(swinir._ln(t, sd, f"{key}.norm2"), sd, f"{key}.mlp", ops)


def ocab(t, sd, key, hw, heads, win, ow, ops: Ops):
    """The overlapping cross-attention block on tokens (n, h w, c)."""
    n, length, c = t.shape
    h, w = hw
    qkv = ops.linear(swinir._ln(t, sd, f"{key}.norm1"), sd[f"{key}.qkv.weight"],
                     sd[f"{key}.qkv.bias"]).reshape(n, h, w, 3, c)
    q, k, v = qkv.unbind(3)
    pad = (ow - win) // 2
    rows = (torch.arange(h // win)[:, None] * win + torch.arange(ow)[None, :]).to(t.device)
    cols = (torch.arange(w // win)[:, None] * win + torch.arange(ow)[None, :]).to(t.device)

    def gather(z):
        z = F.pad(z, (0, 0, pad, pad, pad, pad))         # zeros around the map
        z = z[:, rows[:, None, :, None], cols[None, :, None, :]]   # (n, nh, nw, ow, ow, c)
        return z.reshape(-1, ow * ow, c)

    table = sd[f"{key}.relative_position_bias_table"]
    bias = table[oca_index(win, ow).to(table.device).reshape(-1)].reshape(win * win, ow * ow,
                                                                         heads)
    y = _attend(swinir._windows(q, win), gather(k), gather(v), bias, heads, ops)
    y = ops.linear(y, sd[f"{key}.proj.weight"], sd[f"{key}.proj.bias"])
    t = t + swinir._unwindows(y, win, n, h, w).reshape(n, length, c)
    return t + _mlp(swinir._ln(t, sd, f"{key}.norm2"), sd, f"{key}.mlp", ops)


def forward(sd: dict, x: torch.Tensor, p: dict, ops: Ops | None = None) -> torch.Tensor:
    """(N, 2, H, W) -> (N, 1, H, W) under ``ops`` (full float32 by default)."""
    ops = ops or Ops()
    r, win, ow = p["upscale"], p["window_size"], overlap(p)

    def conv(x, key):
        return ops.conv(x, sd[f"{key}.weight"], sd[f"{key}.bias"])

    with full_f32():
        hh, ww = x.shape[-2:]
        x = F.pixel_unshuffle(x, r)
        h, w = x.shape[-2:]
        ph, pw = (-h) % win, (-w) % win           # the model wrapper's reflect pad
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            h, w = h + ph, w + pw
        x = conv(x, "conv_first")
        n, c = x.shape[:2]
        t = swinir._ln(x.flatten(2).transpose(1, 2), sd, "patch_embed.norm")
        for i, (depth, heads) in enumerate(zip(p["depths"], p["num_heads"])):
            g = f"layers.{i}.residual_group"
            y = t
            for j in range(depth):
                y = hab(y, sd, f"{g}.blocks.{j}", (h, w), heads, win,
                        0 if j % 2 == 0 else win // 2, p, ops)
            y = ocab(y, sd, f"{g}.overlap_attn", (h, w), heads, win, ow, ops)
            y = conv(y.transpose(1, 2).reshape(n, c, h, w), f"layers.{i}.conv")
            t = y.flatten(2).transpose(1, 2) + t
        t = swinir._ln(t, sd, "norm").transpose(1, 2).reshape(n, c, h, w)
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
