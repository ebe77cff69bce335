"""Whole-granule tiled SR inference, the serving hot path.

Port of ``sifsr_tpu/inference.py``. The reference predicts a 1200x1200 LST
granule block by block at batch 1 on the host (predict.py:84-103). Here:

1. host: tile the granule into 64x64 LST / 256x256 NDVI blocks (one reshape);
2. device: normalise -> bicubic x4 (matmul) -> U-Net -> de-normalise, over a
   whole batch of blocks at once;
3. host: scatter the SR blocks back into the 4800x4800 mosaic.

On a CUDA device the batch loop is pipelined over three streams: the upload
of batch i+1 (pinned host memory, its own stream) and the download of batch
i-1 overlap the compute of batch i, with ``pipeline_depth`` batches in
flight.

``coverage`` reproduces the reference's (vacuous) cloud/sea skip test by
default (1.0); invalid blocks still run through the batch and are zeroed in
the mosaic. Not ported yet (ROADMAP): the ``mesh`` data-parallel path, the
``device_tiling`` all-on-device mode, the ``wire='int'`` transfer codec and
``mode='auto'``'s link probe.
"""

from __future__ import annotations

import functools
from collections import deque

import numpy as np
import torch

from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.device import full_f32_convs, resolve_device
from sifsr_tpu_torch.models.fused import InferenceModelB2
from sifsr_tpu_torch.ops.resize import upsample_bicubic

__all__ = ["tile_granule", "untile_mosaic", "make_sr_step", "predict_granule"]


def tile_granule(lst: np.ndarray, ndvi: np.ndarray, window: int = 64, factor: int = 4):
    """(H, W) LST + (fH, fW) NDVI -> (N, window, window), (N, f·window, f·window).

    Blocks are row-major; partial edge blocks are dropped (1200/64 -> 18x18 =
    324 blocks, like the reference's loop)."""
    gh, gw = lst.shape[0] // window, lst.shape[1] // window
    lst = lst[: gh * window, : gw * window]
    fwin = window * factor
    ndvi = ndvi[: gh * fwin, : gw * fwin]
    lst_blocks = lst.reshape(gh, window, gw, window).transpose(0, 2, 1, 3).reshape(-1, window, window)
    ndvi_blocks = ndvi.reshape(gh, fwin, gw, fwin).transpose(0, 2, 1, 3).reshape(-1, fwin, fwin)
    return lst_blocks, ndvi_blocks, (gh, gw)


def untile_mosaic(blocks: np.ndarray, grid: tuple[int, int]) -> np.ndarray:
    """(N, fwin, fwin) row-major blocks -> (gh*fwin, gw*fwin) mosaic."""
    gh, gw = grid
    fwin = blocks.shape[-1]
    return blocks.reshape(gh, gw, fwin, fwin).transpose(0, 2, 1, 3).reshape(gh * fwin, gw * fwin)


def _as_f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def make_sr_step(stats: Statistics, compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
    """The batched float SR step:
    (model, lst_blocks (N,64,64) K, ndvi_blocks (N,256,256)) -> (N,256,256) K,
    ``model`` an ``InferenceModelB2`` already on ``device`` in ``compute_dtype``.

    Normalisation and the bicubic x4 stay in float32; the U-Net runs in
    ``compute_dtype``. A float32 step runs its convs with TF32 disabled (the
    JAX float32 step uses HIGHEST precision); its pads are the materialised
    replicate pads (the JAX ``pad_impl='explicit'`` form)."""
    dev = resolve_device(device)
    exact = compute_dtype == torch.float32

    @torch.no_grad()
    def sr_step(model, lst_blocks, ndvi_blocks):
        lst_n = (_as_f32(lst_blocks, dev) - stats.mean_lst) / stats.std_lst
        ndvi_n = (_as_f32(ndvi_blocks, dev) - stats.mean_ndvi) / stats.std_ndvi
        x = torch.stack([upsample_bicubic(lst_n, 4), ndvi_n], dim=-1).to(compute_dtype)
        with full_f32_convs(exact):
            sr = model(x)[..., 0]
        return sr.to(torch.float32) * stats.std_lst + stats.mean_lst

    return sr_step


class _Pipeline:
    """Keeps up to ``depth`` batches in flight and hands finished ones to
    ``consume(start, stop, sr_numpy)`` in order. On CUDA the upload, the
    compute and the download each run on their own stream."""

    def __init__(self, device: torch.device, depth: int, consume):
        self.device, self.depth, self.consume = device, max(depth, 1), consume
        self.pending: deque = deque()
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def submit(self, start, stop, step, params, lst_b, ndvi_b):
        if not self.cuda:
            self.pending.append((start, stop, step(params, lst_b, ndvi_b), None))
        else:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.h2d):
                lst_d = torch.from_numpy(lst_b).pin_memory().to(self.device, non_blocking=True)
                ndvi_d = torch.from_numpy(ndvi_b).pin_memory().to(self.device, non_blocking=True)
            compute.wait_stream(self.h2d)
            lst_d.record_stream(compute)
            ndvi_d.record_stream(compute)
            sr = step(params, lst_d, ndvi_d)
            self.d2h.wait_stream(compute)
            with torch.cuda.stream(self.d2h):
                host = torch.empty(sr.shape, dtype=sr.dtype, pin_memory=True)
                host.copy_(sr, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.d2h)
            sr.record_stream(self.d2h)
            self.pending.append((start, stop, host, done))
        if len(self.pending) >= self.depth:
            self.drain_one()

    def drain_one(self):
        start, stop, out, done = self.pending.popleft()
        if done is not None:
            done.synchronize()
        self.consume(start, stop, out.numpy())

    def finish(self):
        while self.pending:
            self.drain_one()


def predict_granule(
    variables,
    lst_granule: np.ndarray,
    ndvi_granule: np.ndarray,
    stats: Statistics,
    batch_size: int = 324,
    coverage: float = 1.0,
    compute_dtype: torch.dtype = torch.bfloat16,
    ndvi_clip: bool = True,
    overlap: int = 0,
    window: int = 64,
    factor: int = 4,
    sr_step=None,
    step_params=None,
    pipeline_depth: int = 3,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """SR a whole granule; returns the (factor·H, factor·W) Kelvin mosaic.

    variables: a ModelB2 state dict (``cli.predict.load_variables``), used
    when no ``sr_step`` is given.

    coverage: max allowed fraction of invalid (0 K) pixels per block before a
    block is zeroed in the output; 1.0 reproduces the reference.

    overlap (coarse pixels, 0 = reference behaviour): tiles are taken at
    stride window-overlap and blended with a separable trapezoid taper.

    sr_step/step_params: serving-step override, e.g. the int8 step of
    ``models.int8_serving``; called as sr_step(step_params, lst_batch,
    ndvi_batch) on the device. The tail batch is zero-padded to
    ``batch_size`` so every step sees one shape.
    """
    dev = resolve_device(device)
    if ndvi_clip:
        ndvi_granule = np.clip(ndvi_granule, -1.0, 1.0)  # predict.py:88-89
    fwin = window * factor
    if sr_step is None:
        sr_step = make_sr_step(stats, compute_dtype, dev)
        step_params = InferenceModelB2.from_variables(variables).to(dev, compute_dtype)

    def run_batches(lst_blocks, ndvi_blocks, n, consume):
        pipe = _Pipeline(dev, pipeline_depth, consume)
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            pad = batch_size - (stop - start)
            lst_b = np.ascontiguousarray(lst_blocks[start:stop], np.float32)
            ndvi_b = np.ascontiguousarray(ndvi_blocks[start:stop], np.float32)
            if pad:
                lst_b = np.concatenate([lst_b, np.zeros((pad, window, window), np.float32)])
                ndvi_b = np.concatenate([ndvi_b, np.zeros((pad, fwin, fwin), np.float32)])
            pipe.submit(start, stop, sr_step, step_params, lst_b, ndvi_b)
        pipe.finish()

    if overlap == 0:
        lst_blocks, ndvi_blocks, grid = tile_granule(lst_granule, ndvi_granule, window, factor)
        n = lst_blocks.shape[0]
        keep = (lst_blocks == 0.0).mean(axis=(1, 2)) <= coverage
        out = np.zeros((n, fwin, fwin), dtype=np.float32)

        def consume(start, stop, sr):
            out[start:stop] = sr[: stop - start]

        run_batches(lst_blocks, ndvi_blocks, n, consume)
        out[~keep] = 0.0
        return untile_mosaic(out, grid)

    # ---- overlapped tiles with trapezoid blending
    stride = window - overlap
    gh = lst_granule.shape[0] // window
    gw = lst_granule.shape[1] // window
    h_lim, w_lim = gh * window, gw * window
    ys = list(range(0, h_lim - window + 1, stride))
    if ys[-1] != h_lim - window:
        ys.append(h_lim - window)
    xs = list(range(0, w_lim - window + 1, stride))
    if xs[-1] != w_lim - window:
        xs.append(w_lim - window)
    origins = [(y, x) for y in ys for x in xs]

    lst_blocks = np.stack([lst_granule[y : y + window, x : x + window] for y, x in origins])
    ndvi_blocks = np.stack(
        [ndvi_granule[factor * y : factor * (y + window), factor * x : factor * (x + window)]
         for y, x in origins]
    )
    keep = (lst_blocks == 0.0).mean(axis=(1, 2)) <= coverage

    ramp = overlap * factor
    taper_1d = np.ones(fwin, np.float32)
    if ramp > 0:
        taper_1d[:ramp] = np.linspace(1.0 / (ramp + 1), 1.0, ramp, endpoint=False)
        taper_1d[-ramp:] = taper_1d[:ramp][::-1]
    taper = np.outer(taper_1d, taper_1d)

    acc = np.zeros((h_lim * factor, w_lim * factor), np.float64)
    wacc = np.zeros_like(acc)

    def consume(start, stop, sr):
        for k in range(stop - start):
            if not keep[start + k]:
                continue
            y, x = origins[start + k]
            sl = np.s_[factor * y : factor * y + fwin, factor * x : factor * x + fwin]
            acc[sl] += sr[k] * taper
            wacc[sl] += taper

    run_batches(lst_blocks, ndvi_blocks, len(origins), consume)
    out = np.where(wacc > 0, acc / np.maximum(wacc, 1e-12), 0.0)
    return out.astype(np.float32)
