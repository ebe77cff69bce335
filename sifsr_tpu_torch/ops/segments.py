"""Sums within contiguous segments of a tensor, in one order on every device.

A segmented Hillis-Steele scan: pass ``d`` adds, at each position, the
partial sum ``d`` places before it when that lies in the same segment. The
passes are elementwise float64 additions, so the CPU and the card add the
same numbers in the same order. CUDA's ``index_add_``, ``scatter_add_`` and
weighted ``bincount`` sum with atomics, in an order that changes from run to
run; a difference of two entries of one global prefix sum loses the digits
of everything before the segment.
"""

from __future__ import annotations

import torch

__all__ = ["segment_scan"]


def segment_scan(v: torch.Tensor, seg_start: torch.Tensor, max_len: int) -> torch.Tensor:
    """Inclusive sums of ``v`` along its last axis within segments: position
    ``p``'s segment starts at ``seg_start[p]``, and no segment is longer than
    ``max_len``."""
    pos = torch.arange(v.shape[-1], device=v.device)
    d = 1
    while d < max_len:
        prev = torch.nn.functional.pad(v[..., :-d], (d, 0))
        v = v + torch.where(pos - d >= seg_start, prev, torch.zeros_like(prev))
        d *= 2
    return v
