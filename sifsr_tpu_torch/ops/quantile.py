"""The linear quantile with the JAX package's rounding (``jnp.quantile``).

numpy's quantile forms its index in float64 and interpolates as
``a + (b - a)·t``; ``jnp.quantile`` forms the index ``q·(n - 1)`` in the
array's float type (for float32, n - 1 itself rounds past 2^24) and
interpolates as ``low·(1 - t) + high·t``. Where a quantile sets an int8
scale (``--calib-quantile``) or a stratum threshold, one ulp moves values
across a rounding or a stratum boundary, so the port takes JAX's rule.
"""

from __future__ import annotations

import torch

__all__ = ["quantile_linear"]


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of the last axis of a float tensor, (..., n) -> (...),
    as ``jnp.quantile(x, q, axis=-1)`` with method 'linear' computes it."""
    n = x.shape[-1]
    pos = torch.tensor(q, dtype=x.dtype) * torch.tensor(n - 1, dtype=x.dtype)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    lo_v = torch.kthvalue(x, int(lo.clamp(max=n - 1)) + 1, dim=-1).values
    hi_v = torch.kthvalue(x, int(hi.clamp(max=n - 1)) + 1, dim=-1).values
    return lo_v * w_lo.to(x.device) + hi_v * w_hi.to(x.device)
