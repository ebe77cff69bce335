"""Fresh HAT weights for the plain reference, drawn from a seed on the
device in one draw per rule, as ``hat_arch.py`` initialises them: Linear
weights and both kinds of relative-position bias table a normal of
standard deviation 0.02 truncated at +-2 (timm's ``trunc_normal_``),
Linear biases zero, LayerNorm scale 1 and shift 0, and every conv, the
CAB's 1x1s included, PyTorch's default (weight and bias uniform in
+-1/sqrt(fan_in)). ``reference/swinir_weights.py`` draws SwinIR's by the
same rule from SwinIR's plan."""

from __future__ import annotations

import math

import torch

from benchmark.reference.hat import param_plan

STD = 0.02


def init_state(gen: torch.Generator, device, p: dict) -> dict:
    plan = param_plan(p)
    normal = [(n, s) for n, s, kind in plan if kind in ("linear_w", "table")]
    uniform = [(n, s) for n, s, kind in plan if kind in ("conv_w", "conv_b")]
    flat_n = torch.empty(sum(math.prod(s) for _, s in normal), device=device)
    torch.nn.init.trunc_normal_(flat_n, 0.0, STD, -2.0, 2.0, generator=gen)
    flat_u = torch.empty(sum(math.prod(s) for _, s in uniform), device=device)
    flat_u.uniform_(-1.0, 1.0, generator=gen)
    fan_in = {n[:-len(".weight")]: math.prod(s[1:]) for n, s, kind in plan if kind == "conv_w"}
    out, at_n, at_u = {}, 0, 0
    for name, shape, kind in plan:
        size = math.prod(shape)
        if kind in ("linear_w", "table"):
            out[name] = flat_n[at_n:at_n + size].reshape(shape).clone()
            at_n += size
        elif kind in ("conv_w", "conv_b"):
            bound = 1.0 / math.sqrt(fan_in[name.rsplit(".", 1)[0]])
            out[name] = (flat_u[at_u:at_u + size] * bound).reshape(shape)
            at_u += size
        elif kind == "ln_w":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
