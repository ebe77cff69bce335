"""Seeded inputs that every traffic kind shares: independent streams of a
run's seed, and synthetic MODIS fields.

The fields are smooth sinusoids of seeded direction and phase plus a
little pixel noise (``chip_smoke.synthetic_granule``'s recipe), made on the
device with a ``torch.Generator`` and copied to the host once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# cycles across a granule: LST and NDVI vary on scales of a few blocks
_LST_FREQS = (7.3, 13.1, 21.7)
_NDVI_FREQS = (9.1, 17.3, 33.9)
# cycles across one 256² training patch
PAIR_FREQS = (1.3, 2.9, 5.1)

_MASK64 = (1 << 64) - 1


def _seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one independent stream of a run's seed."""
    return int(np.random.SeedSequence([seed & _MASK64, stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(_seed(seed, stream))


def device_generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_seed(seed, stream))


def fields(gen: torch.Generator, count: int, n: int, freqs, device) -> torch.Tensor:
    """(count, n, n) mean of len(freqs) unit sinusoids of seeded direction
    and phase, with ``freqs`` cycles across the field."""
    ang = torch.rand((count, len(freqs), 2), generator=gen, device=device, dtype=torch.float64)
    theta, phase = ang[..., 0] * math.pi, ang[..., 1] * 2 * math.pi
    f = torch.tensor(freqs, dtype=torch.float64, device=device) * 2 * math.pi
    ky = (f * torch.cos(theta)).to(torch.float32)[..., None, None]   # (count, k, 1, 1)
    kx = (f * torch.sin(theta)).to(torch.float32)[..., None, None]
    t = torch.linspace(0, 1, n, device=device, dtype=torch.float32)
    out = torch.zeros((count, n, n), device=device, dtype=torch.float32)
    for k in range(len(freqs)):
        out += torch.sin(ky[:, k] * t[None, :, None] + kx[:, k] * t[None, None, :]
                         + phase[:, k, None, None].to(torch.float32))
    return out / len(freqs)


def granule(gen: torch.Generator, lst_px: int, factor: int, device):
    """One synthetic granule: (lst (lst_px², 290-320 K), ndvi ((factor
    lst_px)², 0.1-0.8)) float32 numpy arrays."""
    lst = 305.0 + 24.0 * fields(gen, 1, lst_px, _LST_FREQS, device)[0]
    lst += 0.3 * torch.randn((lst_px, lst_px), generator=gen, device=device)
    n = factor * lst_px
    ndvi = 0.45 + 0.6 * fields(gen, 1, n, _NDVI_FREQS, device)[0]
    ndvi += 0.02 * torch.randn((n, n), generator=gen, device=device)
    return (lst.clamp_(290.0, 320.0).cpu().numpy(), ndvi.clamp_(0.1, 0.8).cpu().numpy())
