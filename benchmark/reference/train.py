"""The plain reference of one ``predef_filters`` training step (SIF-NN-SR1,
the paper's train_model_B_predef_filters.py): the model in train mode, the
sensor-model loss and the Sobel perceptual loss, autograd, and Adam.

    loss = alpha * Huber(renorm(degrade(unnorm(SR))), LST)
         + (1 - alpha) * Huber(sobel(SR), gamma * sobel(NDVI))

``degrade`` is the reference's chain written out: reflect pad by the PSF's
half width, the normalised Gaussian PSF as a zero-padded 'same' conv, the
bicubic 1/4 decimation (``F.interpolate``, no antialias) and a crop of
half width / 4 at each border. Adam is written out (torch's defaults:
betas 0.9/0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.modelb2 import Ops, bicubic_x4, forward, full_f32, trainable

_SOBEL = np.asarray([
    [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
    [[1, 0, -1], [2, 0, -2], [1, 0, -1]],
    [[2, 1, 0], [1, 0, -1], [0, -1, -2]],
    [[0, 1, 2], [-1, 0, 1], [-2, -1, 0]],
], np.float32)[:, None]


def huber(pred, target):
    return F.huber_loss(pred, target, reduction="mean", delta=1.0)


def psf_kernel(factor: int = 4, mtf: float = 0.1) -> tuple[np.ndarray, int]:
    """The normalised 2-D Gaussian whose MTF is ``mtf`` at the coarse
    Nyquist frequency, and its half width (utils.py's generate_psf_kernel
    at res 1, mtf_res = factor)."""
    hkw = math.ceil(factor / 1.0)
    sigma = math.sqrt(-math.log(mtf) / 2.0) / (math.pi * (0.5 / factor))
    t = np.arange(-hkw, hkw + 1, dtype=np.float64)
    k = np.exp(-(t[:, None] ** 2 + t[None, :] ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32), hkw


def degrade(x: torch.Tensor, factor: int = 4, mtf: float = 0.1) -> torch.Tensor:
    """(N, 1, H, W) Kelvin -> (N, 1, H/factor, W/factor)."""
    k, hkw = psf_kernel(factor, mtf)
    y = F.pad(x, (hkw,) * 4, mode="reflect")
    y = F.conv2d(y, torch.as_tensor(k, device=x.device)[None, None], padding=hkw)
    n = y.shape[-1] // factor
    y = F.interpolate(y, size=(n, n), mode="bicubic", align_corners=False)
    c = hkw // factor
    return y[..., c:n - c, c:n - c]


def loss_predef(sr, lst, ndvi, alpha, gamma, stats):
    """sr (N,1,H,W), lst (N,1,h,w), ndvi (N,1,H,W), all normalised."""
    down = degrade(sr * stats["std_lst"] + stats["mean_lst"])
    ds = huber((down - stats["mean_lst"]) / stats["std_lst"], lst)
    bank = torch.as_tensor(_SOBEL, device=sr.device)
    percep = huber(F.conv2d(sr, bank, padding=1), gamma * F.conv2d(ndvi, bank, padding=1))
    return alpha * ds + (1.0 - alpha) * percep


def train_steps(sd0: dict, batches: list, train_cfg: dict, stats: dict, device,
                ops: Ops | None = None):
    """One step a batch from ``sd0``. Returns (losses, the first step's
    gradients, the parameters after the last step)."""
    ops = ops or Ops(training=True)
    names = trainable()
    params = {k: sd0[k].detach().clone().requires_grad_(True) for k in names}
    fixed = {k: v for k, v in sd0.items() if k not in params}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    (b1, b2), eps = train_cfg["adam"]["betas"], train_cfg["adam"]["eps"]
    lr = train_cfg["learning_rate"]
    losses, grad1 = [], None
    for t, batch in enumerate(batches, 1):
        lst = torch.as_tensor(batch["lst"], device=device).movedim(-1, 1)
        ndvi = torch.as_tensor(batch["ndvi"], device=device).movedim(-1, 1)
        with full_f32():
            x = torch.cat([bicubic_x4(lst), ndvi], dim=1)
            sr = forward({**fixed, **params}, x, ops)
            loss = loss_predef(sr, lst, ndvi, train_cfg["alpha"], train_cfg["gamma"], stats)
            grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                grad1 = {k: g.clone() for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.sub_(lr / (1 - b1 ** t) * m[k] / denom)
    return losses, grad1, {k: p.detach() for k, p in params.items()}
