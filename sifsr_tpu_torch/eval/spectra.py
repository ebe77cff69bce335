"""Fourier-space frequency-restitution metrics (reference utils.py:598-662).

Port of ``sifsr_tpu/eval/spectra.py``. The radial binning is one sum per
ring over a precomputed ring-index map (ring r holds the pixels with
r < dist(center) <= r+1), and the spectrum is batched over leading axes,
through ``torch.fft`` on the tensor's device.

The transform and the ring means run in float64 and the spectrum comes out
in float32. torch's float32 FFT is off the float64 one by up to 6e-4 dB in
the rings of a 300 K image of other than power-of-two size (JAX's by up to
1.2e-4 dB), while the float64 form stays within 1e-5 dB of
``attenuation_spectrum_np`` (``tests/test_torch_eval_metrics.py``). The
ring sums are segmented scans over the pixels in ring order
(``ops.segments``), not a scatter-add: CUDA's ``index_add_`` and weighted
``bincount`` sum with atomics, in an order that changes from run to run. A
difference of one global prefix sum, as before, carried an error of the
whole prefix into the high-frequency rings, enough to move a float32 dB
value of ``cli.compare_methods``'s scores by an ulp.

Conventions preserved exactly:
- input to the radial average is fftshift(abs(fft2(image)));
- entry 0 of the spectrum is the ratio 1.0 (f0/f0), not 0 dB, a reference
  quirk (utils.py:619);
- entries 1.. are 10*(log10(ring mean) - log10(f0)) for r = 0..min(center)-2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sifsr_tpu_torch.ops.segments import segment_scan

__all__ = ["attenuation_spectrum", "pfr", "afr", "frr", "fro", "fru", "attenuation_spectrum_np"]


@functools.lru_cache(maxsize=None)
def _ring_ids(h: int, w: int) -> tuple[np.ndarray, int]:
    """Per-pixel ring index for a fftshifted (h, w) spectrum.

    Ring r (0-based) = pixels with r < dist <= r+1 from the center bin;
    the center pixel itself gets id -1 (it is the f0 reference).
    Returns (ids, n_rings) where n_rings = min(h//2, w//2) - 1 matches the
    reference's loop bound range(0, min(center) - 1).
    """
    cy, cx = h // 2, w // 2
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
    # ring r <=> r^2 < dist2 <= (r+1)^2  <=>  r = ceil(sqrt(dist2)) - 1
    ids = np.ceil(np.sqrt(dist2)).astype(np.int64) - 1
    ids[cy, cx] = -1
    n_rings = min(cy, cx) - 1
    ids[ids >= n_rings] = -1  # out-of-range rings are ignored, like the reference
    return ids, n_rings


@functools.lru_cache(maxsize=8)
def _ring_order(h: int, w: int, device: torch.device):
    """(order, seg_start, last, counts, longest) of ``_ring_ids``: on
    ``device`` the flat indices of the ring pixels sorted by ring, the
    position of each one's ring start in that order, each ring's last
    position and its pixel count (float64, (n_rings,)); the largest count."""
    ids, n_rings = _ring_ids(h, w)
    flat = ids.reshape(-1)
    order = np.flatnonzero(flat >= 0)
    order = order[np.argsort(flat[order], kind="stable")]
    counts = np.bincount(flat[order], minlength=n_rings)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (torch.as_tensor(order, device=device),
            torch.as_tensor(np.repeat(starts, counts), device=device),
            torch.as_tensor(starts + counts - 1, device=device),
            torch.as_tensor(counts.astype(np.float64), device=device), int(counts.max()))


def attenuation_spectrum(image: torch.Tensor) -> torch.Tensor:
    """Radially-averaged attenuation spectrum in dB re f0 of (..., H, W)
    images, float32. A float64 image is transformed as it is (the crops of
    ``cli.compare_methods``), any other as float32.

    Equivalent to compute_2D_attenuation_spectra(fftshift(abs(fft2(image))))
    (utils.py:598-637 + compare_methods.py:312). Returns (..., 1 + n_rings).
    """
    image = torch.as_tensor(image)
    if image.dtype != torch.float64:
        image = image.to(torch.float32)
    h, w = image.shape[-2], image.shape[-1]
    order, seg_start, last, counts, longest = _ring_order(h, w, image.device)

    spec = torch.fft.fftshift(torch.abs(torch.fft.fft2(image.double())), dim=(-2, -1))
    f0 = spec[..., h // 2, w // 2]
    ring_vals = spec.reshape(*spec.shape[:-2], h * w)[..., order]
    means = segment_scan(ring_vals, seg_start, longest)[..., last] / counts
    att = (10.0 * (torch.log10(means) - torch.log10(f0[..., None]))).to(torch.float32)
    head = torch.ones((*spec.shape[:-2], 1), dtype=att.dtype, device=att.device)  # f0/f0 quirk
    return torch.cat([head, att], dim=-1)


# ---- frequency-restitution scores (utils.py:639-662). pb = prediction's
# spectrum, rb = ground truth (ASTER), xb = bicubic floor; all in dB.
def pfr(rb: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Potential frequency restitution: how much GT exceeds bicubic."""
    return torch.sum(torch.clamp_min(rb - xb, 0.0), dim=-1)


def afr(pb: torch.Tensor, rb: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Achieved frequency restitution."""
    return torch.sum(
        torch.maximum(torch.minimum(pb, rb), torch.minimum(xb, rb)) - torch.minimum(rb, xb),
        dim=-1,
    )


def frr(pb: torch.Tensor, rb: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Frequency-restitution ratio AFR/PFR."""
    return afr(pb, rb, xb) / pfr(rb, xb)


def fro(pb: torch.Tensor, rb: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Frequency-restitution overshoot (negative when pb exceeds rb)."""
    return torch.sum(rb - torch.maximum(pb, rb), dim=-1) / torch.sum(rb, dim=-1)


def fru(pb: torch.Tensor, rb: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Frequency-restitution undershoot below the bicubic floor."""
    return torch.sum(xb - torch.minimum(pb, xb), dim=-1) / torch.sum(xb, dim=-1)


def attenuation_spectrum_np(image) -> np.ndarray:
    """numpy form of attenuation_spectrum for variable-shape host-side use
    (the compare_methods batch job sees a different crop shape per pair)."""
    image = np.asarray(image)
    h, w = image.shape
    ids, n_rings = _ring_ids(h, w)
    spec = np.fft.fftshift(np.abs(np.fft.fft2(image)))
    f0 = spec[h // 2, w // 2]
    flat_ids = ids.reshape(-1)
    valid = flat_ids >= 0
    sums = np.bincount(flat_ids[valid], weights=spec.reshape(-1)[valid], minlength=n_rings)
    counts = np.bincount(flat_ids[valid], minlength=n_rings)
    means = sums / counts
    att = 10.0 * (np.log10(means) - np.log10(f0))
    return np.concatenate([[1.0], att])
