"""The ASTER harness's metric block (reference
model_perf_aster_formatds.py:371-438) for every pair in one batched torch
program on the device (port of ``sifsr_tpu/eval/device_metrics.py``).

The crops have a different shape per pair (each pair's warped common area is
a different rectangle). They are PADDED to one (N, H, W) grid (valid data in
the top-left corner) and every metric is computed with masked-window
semantics that equal the per-crop numpy values of ``eval.harness``:

- window metrics (SSIM/GSSIM): only windows lying fully inside a pair's
  valid rectangle contribute; such windows never touch padding, so their
  window means equal the per-crop VALID means (up to float32);
- pixel metrics (PSNR/RMSE/strata): masked sums/counts;
- per-pair percentiles (the gradient strata thresholds, :382-383): one
  ``torch.sort`` over (N, H·W) with a +inf fill, and a per-row gather at the
  fractional index of the VALID count, numpy's linear 'percentile' on the
  crop's values, with the JAX package's float32 index rule;
- the reference's nonzero-RMSE quirk (zeros excluded from stratified RMSE,
  :387-403) is reproduced with a sq > 0 mask.

Where JAX ``vmap``s one pair's program, the port writes the batch out: the
window means and the Sobel stacks are ``conv2d`` over N, in full float32
(``device.full_f32``), as JAX's run at ``Precision.HIGHEST``.

float32 note: window variances of ~300 K imagery cancel catastrophically in
float32 (uxx - ux² loses ~5 of 7 digits), so second-moment statistics are
computed on per-image-centered values (shift-invariant) while the
SSIM/GSSIM luminance terms add the center back.

The one host-side input besides the crops is the ASTER high-frequency field
|aster - PSF-lowpass(aster)| (:377-378): its reflect-boundary lowpass matrix
depends on each crop's exact shape, so it is two small per-pair host matmuls
(``ops.psf.lowpass_matrix``, as the per-pair path); everything downstream of
it runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sifsr_tpu_torch.device import full_f32, resolve_device
from sifsr_tpu_torch.eval.metrics import _valid_window_mean
from sifsr_tpu_torch.ops.psf import lowpass_matrix

__all__ = ["COLUMNS", "pad_crops", "batched_pair_metrics", "device_metric_rows"]

# metric columns produced (performances.csv layout minus LPIPS, which stays
# a weights-gated metric of its own)
COLUMNS = (
    "PSNR",
    "SSIM",
    "RMSE",
    "RMSE (low grad per image)",
    "RMSE (mean grad per image)",
    "RMSE (high grad per image)",
    "GSSIM",
    "RMSE_grad",
)

_SOBELS = np.asarray(
    [
        [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
        [[1, 0, -1], [2, 0, -2], [1, 0, -1]],
        [[2, 1, 0], [1, 0, -1], [0, -1, -2]],
        [[0, 1, 2], [-1, 0, 1], [-2, -1, 0]],
    ],
    dtype=np.float32,
)


def pad_crops(crops: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Pad variable-shape 2-D crops into one (N, H, W) float32 array
    (top-left aligned, zero fill) + the (N, 2) valid shapes."""
    shapes = np.asarray([c.shape for c in crops], np.int32)
    H, W = shapes.max(axis=0)
    out = np.zeros((len(crops), H, W), np.float32)
    for i, c in enumerate(crops):
        out[i, : c.shape[0], : c.shape[1]] = c
    return out, shapes


def _rect_mask(h: torch.Tensor, w: torch.Tensor, H: int, W: int, shrink: int = 0) -> torch.Tensor:
    """(N, H, W) mask of the positions an op with VALID extent ``shrink``
    keeps inside each pair's (h, w) rectangle."""
    rows = torch.arange(H, device=h.device)[None, :, None] < (h - shrink)[:, None, None]
    cols = torch.arange(W, device=h.device)[None, None, :] < (w - shrink)[:, None, None]
    return rows & cols


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(-2, -1))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N,) mean of x over each pair's mask (float32 mask)."""
    return _sum(x * mask) / torch.clamp_min(_sum(mask), 1)


def _conv_valid(x: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """Cross-correlate (N, H, W) with a stack of (K, 3, 3) kernels ->
    (N, K, H-2, W-2). The reference applies scipy convolve2d (a true
    convolution); the Sobel set here enters only through the combined
    magnitude, where the orientation cancels."""
    k = torch.as_tensor(kernels, device=x.device)[:, None]
    return F.conv2d(x[:, None], k)


def _masked_percentile(vals: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """numpy.percentile(vals[i][mask[i]], q) with linear interpolation, per
    pair: one sort over (N, H·W) with +inf where the mask is off, the index
    q/100 · (n - 1) formed in float32 as the JAX package does."""
    n_pairs = vals.shape[0]
    flat = torch.where(mask.reshape(n_pairs, -1), vals.reshape(n_pairs, -1),
                       torch.tensor(float("inf"), device=vals.device))
    s = torch.sort(flat, dim=-1).values
    n = mask.reshape(n_pairs, -1).sum(dim=-1)
    pos = torch.tensor(q / 100.0, dtype=torch.float32, device=vals.device) * (n - 1).to(torch.float32)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    frac = pos - lo
    s_lo = s.gather(1, lo.to(torch.int64)[:, None])[:, 0]
    s_hi = s.gather(1, hi.to(torch.int64)[:, None])[:, 0]
    return s_lo * (1 - frac) + s_hi * frac


@torch.no_grad()
def batched_pair_metrics(sr: torch.Tensor, aster: torch.Tensor, grad: torch.Tensor,
                         shapes: torch.Tensor, win: int = 7) -> dict:
    """(N, H, W) padded float32 crops + (N, 2) valid shapes -> dict of (N,)
    metric columns, all in one batched program on the tensors' device."""
    with full_f32():
        return _pair_metrics(sr, aster, grad, shapes, win)


def _pair_metrics(sr, aster, grad, shapes, win):
    N, H, W = sr.shape
    h, w = shapes[:, 0].to(torch.int64), shapes[:, 1].to(torch.int64)
    m = _rect_mask(h, w, H, W)
    mf = m.to(torch.float32)
    inf = torch.tensor(float("inf"), device=sr.device)

    def per_pair(v):
        return v[:, None, None]

    # data_range over both images' valid pixels (:373-375)
    maxi = torch.maximum(torch.where(m, aster, -inf).amax(dim=(-2, -1)),
                         torch.where(m, sr, -inf).amax(dim=(-2, -1)))
    mini = torch.minimum(torch.where(m, aster, inf).amin(dim=(-2, -1)),
                         torch.where(m, sr, inf).amin(dim=(-2, -1)))
    data_range = maxi - mini
    c1 = per_pair(torch.square(0.01 * data_range))
    c2 = per_pair(torch.square(0.03 * data_range))
    n_valid = torch.clamp_min(_sum(mf), 1)

    diff = (sr - aster) * mf
    sq = diff * diff
    mse = _sum(sq) / n_valid
    psnr = 10.0 * torch.log10(torch.square(data_range) / mse)
    rmse = torch.sqrt(mse)

    # ---- stratified RMSE by ASTER HF-gradient quartiles (:382-403), with
    # the reference's exact-zero exclusion quirk
    lo_t = per_pair(_masked_percentile(grad, m, 25.0))
    hi_t = per_pair(_masked_percentile(grad, m, 75.0))

    def strat(stratum):
        sel = stratum & m & (sq > 0)
        cnt = _sum(sel)
        val = torch.sqrt(_sum(torch.where(sel, sq, 0.0)) / torch.clamp_min(cnt, 1))
        return torch.where(cnt > 0, val, torch.tensor(float("nan"), device=sr.device))

    rmse_low = strat(grad < lo_t)
    rmse_mid = strat((grad >= lo_t) & (grad <= hi_t))
    rmse_high = strat(grad > hi_t)

    # ---- center second-moment inputs (float32 cancellation; module docstring)
    cx = per_pair(_masked_mean(aster, mf))
    cy = per_pair(_masked_mean(sr, mf))
    xs = (aster - cx) * mf
    ys = (sr - cy) * mf

    # ---- SSIM over windows fully inside the valid rect (skimage semantics:
    # reflect-filtered then border-cropped == VALID windows; metrics.py)
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)
    wmask = _rect_mask(h, w, H - win + 1, W - win + 1, shrink=win - 1).to(torch.float32)
    ux_c = _valid_window_mean(xs, win)
    uy_c = _valid_window_mean(ys, win)
    vx = cov_norm * (_valid_window_mean(xs * xs, win) - ux_c * ux_c)
    vy = cov_norm * (_valid_window_mean(ys * ys, win) - uy_c * uy_c)
    vxy = cov_norm * (_valid_window_mean(xs * ys, win) - ux_c * uy_c)
    ux = ux_c + cx
    uy = uy_c + cy
    ssim_map = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    ssim = _sum(ssim_map * wmask) / torch.clamp_min(_sum(wmask), 1)

    # ---- 4-direction Sobel gradient-magnitude RMSE (:412-425)
    g_sr = _conv_valid(sr, _SOBELS)
    g_as = _conv_valid(aster, _SOBELS)
    mag_sr = torch.sqrt(torch.sum(g_sr * g_sr, dim=1))
    mag_as = torch.sqrt(torch.sum(g_as * g_as, dim=1))
    gmask = _rect_mask(h, w, H - 2, W - 2, shrink=2).to(torch.float32)
    rmse_grad = torch.sqrt(
        _sum(torch.square(mag_sr - mag_as) * gmask) / torch.clamp_min(_sum(gmask), 1))

    # ---- GSSIM (reference utils.py:1904-2005): luminance from raw images
    # (inner 1-px trim), contrast/structure from the 2-direction Sobel mags
    f2 = _conv_valid(aster, _SOBELS[:2])
    g2 = _conv_valid(sr, _SOBELS[:2])
    f_mag = torch.sqrt(torch.sum(f2 * f2, dim=1))
    g_mag = torch.sqrt(torch.sum(g2 * g2, dim=1))
    ufc = _valid_window_mean(xs[:, 1:-1, 1:-1], win)
    ugc = _valid_window_mean(ys[:, 1:-1, 1:-1], win)
    uf = _valid_window_mean(f_mag, win)
    ug = _valid_window_mean(g_mag, win)
    vf = cov_norm * (_valid_window_mean(f_mag * f_mag, win) - uf * uf)
    vg = cov_norm * (_valid_window_mean(g_mag * g_mag, win) - ug * ug)
    vfg = cov_norm * (_valid_window_mean(f_mag * g_mag, win) - uf * ug)
    lum = (2 * (ufc + cx) * (ugc + cy) + c1) / (
        torch.square(ufc + cx) + torch.square(ugc + cy) + c1)
    con = (2 * torch.sqrt(vf) * torch.sqrt(vg) + c2) / (vf + vg + c2)
    struct = (vfg + c2) / (torch.sqrt(vf) * torch.sqrt(vg) + c2 / 2)
    gwmask = _rect_mask(h, w, H - 2 - win + 1, W - 2 - win + 1,
                        shrink=2 + win - 1).to(torch.float32)
    gssim = _sum(lum * con * struct * gwmask) / torch.clamp_min(_sum(gwmask), 1)

    return {
        "PSNR": psnr,
        "SSIM": ssim,
        "RMSE": rmse,
        "RMSE (low grad per image)": rmse_low,
        "RMSE (mean grad per image)": rmse_mid,
        "RMSE (high grad per image)": rmse_high,
        "GSSIM": gssim,
        "RMSE_grad": rmse_grad,
    }


def device_metric_rows(crop_pairs: list[tuple[np.ndarray, np.ndarray]],
                       device: str | torch.device = "cuda") -> list[dict]:
    """Host side: pad the (crop_sr, crop_aster) list, build the per-pair
    ASTER HF-gradient fields (host matmuls: a shape-dependent reflect-pad
    lowpass), run the one batched metric program on ``device``, return
    per-pair dicts of ``COLUMNS``."""
    dev = resolve_device(device)
    srs = [p[0] for p in crop_pairs]
    asters = [p[1] for p in crop_pairs]
    grads = []
    for a in asters:
        mat = lowpass_matrix(a.shape[0], 4, 0.1)
        mat2 = lowpass_matrix(a.shape[1], 4, 0.1)
        grads.append(np.abs(a - mat @ a @ mat2.T))
    sr_pad, shapes = pad_crops(srs)
    aster_pad, _ = pad_crops(asters)
    grad_pad, _ = pad_crops(grads)
    out = batched_pair_metrics(*(torch.as_tensor(a, device=dev)
                                 for a in (sr_pad, aster_pad, grad_pad, shapes)))
    cols = {k: v.cpu().numpy() for k, v in out.items()}
    return [{k: float(cols[k][i]) for k in COLUMNS} for i in range(len(crop_pairs))]
