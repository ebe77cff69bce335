"""Whole-granule tiled SR inference, the serving hot path.

Port of ``sifsr_tpu/inference.py``. The reference predicts a 1200x1200 LST
granule block by block at batch 1 on the host (predict.py:84-103). Here:

1. host: tile the granule into 64x64 LST / 256x256 NDVI blocks, copied once
   (the float32 cast and the block layout together) straight into the
   buffer the batches upload from, pinned memory on CUDA, and the NDVI
   clipped there in place;
2. device: normalise -> bicubic x4 (matmul) -> U-Net -> de-normalise, over a
   whole batch of blocks at once;
3. host: write each downloaded batch straight into the 4800x4800 mosaic.

On a CUDA device the batch loop is pipelined over three streams: the upload
of batch i+1 (from the pinned staging, its own stream) and the download of
batch i-1 (into a pinned buffer) overlap the compute of batch i, with
``pipeline_depth`` batches in flight (``mode='host_pipeline'``). Each batch
is filled into the staging just before it is submitted, so the host copies
batch i+1's inputs in and batch i-1's download out while the card steps
batch i: a call of 128 blocks or more (a whole 324-block granule) is
stepped as about four equal batches for that (``_batches``). The staging
and the download buffers come from torch's caching host allocator, which
hands a buffer out again only once the copies recorded on it are done: the
host arrays a call on CUDA creates are its coverage mask and the mosaic it
returns, a new array on every call (and the wire's codes under
``wire='int'``). The int8 step of
``models.int8_serving`` replays there one CUDA graph of the whole step per
row count: one launch where the step makes about 30, so a batch of a few
blocks no longer waits on the host's enqueue. Its output is the caller's,
a copy made on the compute stream, so the batches in flight never share
it. The graphs' memory does not grow with the row counts seen: one set of
static inputs and output of the most rows seen, one memory pool for every
graph.

Under ``tracing`` each call is a ``predict_granule`` root with the stage
spans ``tile`` (the staging's and the mosaic's allocation, then before each
batch its one copy of the batch's inputs, the NDVI's clip in place and the
coverage test of its blocks), ``pad``
(each batch's row slice of the staging; under a mesh this rank's shard,
its padding rows zeroed in the staging), ``upload`` (the host-to-device
enqueue from the staging), ``step`` (the serving step and the
device-to-host enqueue), ``wait`` (the host waiting on the device) and
``mosaic`` (writing each download into the mosaic, decoding the wire's
codes on the way, zeroing the blocks that fail coverage, releasing the
staging), and the counters ``blocks`` (real
blocks), ``rows`` (batch rows stepped: the real blocks on one device, this
rank's rows, padding included, under a mesh), ``staged_rows`` (the rows
stepped straight from the staging: uploaded from it without a copy on
CUDA, read in place on the CPU), ``host_bytes`` (the bytes of every
host array the call creates, the CPU's plain staging included; torch's
cached pinned buffers are not counted) and ``overlapped_rows`` (the rows of
each batch submitted while an earlier batch of the call is still pending:
counted only where there is one). The int8 step adds ``graph_replays`` and
``graph_captures`` on CUDA.

``device_tiling`` instead uploads the granule once, tiles it, masks by
coverage, runs the batches and assembles the mosaic on the device, and
downloads the mosaic once. ``wire='int'`` ships LST as uint16 (0.02 K a
step), NDVI as int16 (1e-4 a step) and the mosaic back as uint16, decoding
and encoding on the device: every transfer halves. ``mode='auto'`` measures
the host-device link, the host's tiling rate and the step's time once per
process and picks the mode its model of the two walls favours.

``coverage`` reproduces the reference's (vacuous) cloud/sea skip test by
default (1.0); invalid blocks still run through the batch and are zeroed in
the mosaic. ``mesh`` (a ``parallel.Mesh``) splits every batch over a
data-parallel group, one process per device, each rank assembling the whole
mosaic.
"""

from __future__ import annotations

import functools
import sys
import time
from collections import deque

import numpy as np
import torch

from sifsr_tpu_torch import tracing
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.device import full_f32_convs, resolve_device
from sifsr_tpu_torch.models.fused import InferenceModelB2
from sifsr_tpu_torch.ops.resize import upsample_bicubic
from sifsr_tpu_torch.parallel.mesh import gather_rows

__all__ = ["tile_granule", "untile_mosaic", "make_sr_step", "predict_granule", "encode_wire",
           "probe_link", "choose_granule_mode", "WIRE_LST_STEP", "WIRE_NDVI_STEP"]


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


def _grid_runs(start: int, stop: int, gw: int):
    """Blocks ``start:stop`` of a row-major grid ``gw`` blocks wide, as runs
    ``(i, j, rows, cols)``: the blocks ``i:j`` fill the grid rows ``rows`` at
    the columns ``cols``, one partial grid row or whole grid rows."""
    i = start
    while i < stop:
        r, c = divmod(i, gw)
        k = (stop - i) // gw if c == 0 else 0
        if k:
            j, rows, cols = i + k * gw, slice(r, r + k), slice(0, gw)
        else:
            j = min(stop, i - c + gw)
            rows, cols = slice(r, r + 1), slice(c, c + j - i)
        yield i, j, rows, cols
        i = j


def _grid_of(blocks: np.ndarray, rows: slice, cols: slice) -> np.ndarray:
    """A run's (R·C, b, b) blocks as the (R, b, C, b) view of the grid rows
    and columns they fill (``_grid_runs``)."""
    shape = (rows.stop - rows.start, cols.stop - cols.start, *blocks.shape[1:])
    return blocks.reshape(shape).transpose(0, 2, 1, 3)


def _fresh(a: np.ndarray, *sources) -> np.ndarray:
    """``a``; under tracing its bytes count as ``host_bytes`` of the open
    root unless it shares memory with one of ``sources`` (a view, or a cast
    that did not copy)."""
    if tracing.enabled() and not any(np.may_share_memory(a, s) for s in sources):
        tracing.count("host_bytes", a.nbytes)
    return a


def _as_f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def make_sr_step(stats: Statistics, compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", pad_impl: str | None = None):
    """The batched float SR step:
    (model, lst_blocks (N,64,64) K, ndvi_blocks (N,256,256)) -> (N,256,256) K,
    ``model`` an ``InferenceModelB2`` already on ``device`` in ``compute_dtype``.

    Normalisation and the bicubic x4 stay in float32; the U-Net runs in
    ``compute_dtype``. A float32 step runs its convs with TF32 disabled (the
    JAX float32 step uses HIGHEST precision). pad_impl: 'fused' pads by a
    zero-padded conv plus border-ring corrections
    (``models.fused.replicate_conv_fused``); 'explicit' materialises the
    replicate pads. Border pixels differ between the two by float summation
    order. None picks by ``compute_dtype`` the faster of the two on an H100
    (PERF.md): 'explicit' for float32, 'fused' otherwise."""
    dev = resolve_device(device)
    if pad_impl is None:
        pad_impl = "explicit" if compute_dtype == torch.float32 else "fused"
    if pad_impl not in ("fused", "explicit"):
        raise ValueError(f"pad_impl must be 'fused' or 'explicit', got {pad_impl!r}")
    exact = compute_dtype == torch.float32

    @torch.no_grad()
    def sr_step(model, lst_blocks, ndvi_blocks):
        lst_n = (_as_f32(lst_blocks, dev) - stats.mean_lst) / stats.std_lst
        ndvi_n = (_as_f32(ndvi_blocks, dev) - stats.mean_ndvi) / stats.std_ndvi
        x = torch.stack([upsample_bicubic(lst_n, 4), ndvi_n], dim=-1).to(compute_dtype)
        with full_f32_convs(exact):
            sr = model(x, pad_impl=pad_impl)[..., 0]
        return sr.to(torch.float32) * stats.std_lst + stats.mean_lst

    return sr_step


# integer wire formats for the host<->device link (predict_granule wire="int"):
# MODIS-native quantisation steps, so encoding real granules is lossless
# (MOD21/MOD11 LST is uint16 at 0.02 K; MODIS NDVI products are int16 at 1e-4)
WIRE_LST_STEP = 0.02   # K per LSB, uint16
WIRE_NDVI_STEP = 1e-4  # per LSB, int16


def encode_wire(lst: np.ndarray, ndvi: np.ndarray):
    """float32 Kelvin / NDVI -> (uint16, int16) wire arrays (2 bytes/px)."""
    lst_q = np.clip(np.round(lst / WIRE_LST_STEP), 0, 65535)
    ndvi_q = np.clip(np.round(ndvi / WIRE_NDVI_STEP), -32768, 32767)
    lst_w, ndvi_w = lst_q.astype(np.uint16), ndvi_q.astype(np.int16)
    # each input leaves three float temporaries (quotient, rounding, clip)
    tracing.count("host_bytes", 3 * (lst_q.nbytes + ndvi_q.nbytes) + lst_w.nbytes
                  + ndvi_w.nbytes)
    return lst_w, ndvi_w


def _u16_bits(a: np.ndarray) -> np.ndarray:
    """uint16 arrays cross the link as their int16 bit pattern: torch does
    arithmetic on int16, while uint16 is a storage-only dtype there."""
    return a.view(np.int16) if a.dtype == np.uint16 else a


def _put_decoded(dst: np.ndarray, codes: np.ndarray) -> None:
    """The wire's int16 bit patterns of uint16 Kelvin/0.02 into float32 K."""
    np.multiply(codes.view(np.uint16), np.float32(WIRE_LST_STEP), out=dst, dtype=np.float32)


def _decode_wire_out(a: np.ndarray) -> np.ndarray:
    out = _fresh(np.empty(a.shape, np.float32))
    _put_decoded(out, a)
    return out


def _wire_step(sr_step, dev: torch.device):
    """Wrap a serving step with the wire decode/encode on the device: LST
    arrives as the int16 bit pattern of uint16 Kelvin/0.02, NDVI as int16
    NDVI/1e-4, and the SR leaves as the bit pattern of uint16 Kelvin/0.02.
    The output divides by a 0-d device tensor (a scalar divisor would become a
    multiplication by its reciprocal on CUDA)."""
    lst_step = torch.tensor(WIRE_LST_STEP, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def step(params, lst_w, ndvi_w):
        lst_w = torch.as_tensor(lst_w, device=dev)
        ndvi_w = torch.as_tensor(ndvi_w, device=dev)
        lst = (lst_w.to(torch.int32) & 0xFFFF).to(torch.float32) * WIRE_LST_STEP
        ndvi = ndvi_w.to(torch.float32) * WIRE_NDVI_STEP
        sr = sr_step(params, lst, ndvi)
        code = torch.clamp(torch.round(sr / lst_step), 0, 65535).to(torch.int32)
        return torch.where(code >= 32768, code - 65536, code).to(torch.int16)

    return step


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev``: itself on the CPU; on CUDA a copy enqueued
    from pinned memory, from ``t`` itself where it is pinned (a staging
    buffer: ``pin_memory()`` returns it unchanged), else from a pinned copy."""
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _array_to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return _to_device(torch.from_numpy(_fresh(np.ascontiguousarray(a), a)), dev)


def _staging(rows: int, block: int, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A host buffer of ``rows`` (block, block) rows that the batches are
    stepped from: on CUDA pinned memory from torch's caching host allocator
    (not counted), on the CPU a plain fresh array."""
    cuda = dev.type == "cuda"
    t = torch.empty((rows, block, block), dtype=dtype, pin_memory=cuda)
    if not cuda:
        tracing.count("host_bytes", t.numel() * t.element_size())
    return t


# a call of at least 2 x _MIN_ROWS blocks goes as about _SPLIT_INTO batches of
# at least _MIN_ROWS rows, so that the host's copies of one batch run beside
# the card's step of another (a 324-block granule: 4 x 81)
_SPLIT_INTO, _MIN_ROWS = 4, 64


def _batches(n: int, batch_size: int, mesh) -> list[tuple[int, int, int, int]]:
    """``(start, stop, a, b)`` of each batch: its blocks ``start:stop`` and
    the staging rows ``a:b`` this device steps. On one device those are the
    blocks' own rows; under a mesh they are this rank's equal shard of the
    batch zero-padded to the group's next multiple, its padding the rows
    past the n blocks' (only the last batch is padded: ``batch_size``
    splits evenly over the group).

    ``batch_size`` is the most rows a batch takes. On one device n blocks
    go as ``min(_SPLIT_INTO, n // _MIN_ROWS)`` equal batches where that is
    2 or more (n >= 128), still none above ``batch_size``; fewer blocks go
    in batches of ``batch_size``. Under a mesh every batch but the last has
    ``batch_size`` rows: each batch's gather is a collective."""
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    parts = min(_SPLIT_INTO, n // _MIN_ROWS)
    if mesh is None and parts >= 2:
        batch_size = min(batch_size, -(-n // parts))
    out = []
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        shard = -(-(stop - start) // size)
        out.append((start, stop, start + rank * shard, start + (rank + 1) * shard))
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    with tracing.span("wait"):
        torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


@torch.no_grad()
def _run_device_tiling(step, params, lst_g: np.ndarray, ndvi_g: np.ndarray, window: int,
                       factor: int, bs: int, coverage: float, dev: torch.device) -> np.ndarray:
    """The all-on-device granule program of ``device_tiling`` (port of
    ``inference.py:156-193``): one upload of each granule, tiling, the
    coverage mask, the batches (the tile count padded to a multiple of the
    batch) and the mosaic assembly on the device, one download."""
    fwin = window * factor
    gh, gw = lst_g.shape[0] // window, lst_g.shape[1] // window
    nt = gh * gw
    k = -(-nt // bs)
    pad = k * bs - nt
    with tracing.span("upload"):
        lst_d, ndvi_d = _array_to_device(lst_g, dev), _array_to_device(ndvi_g, dev)
    with tracing.span("tile"):
        lst_t = (lst_d[: gh * window, : gw * window].reshape(gh, window, gw, window)
                 .permute(0, 2, 1, 3).reshape(nt, window, window))
        ndvi_t = (ndvi_d[: gh * fwin, : gw * fwin].reshape(gh, fwin, gw, fwin)
                  .permute(0, 2, 1, 3).reshape(nt, fwin, fwin))
        keep = (lst_t == 0).to(torch.float32).mean(dim=(1, 2)) <= coverage
        if pad:
            lst_t = torch.cat([lst_t, lst_t.new_zeros((pad, window, window))])
            ndvi_t = torch.cat([ndvi_t, ndvi_t.new_zeros((pad, fwin, fwin))])
    tracing.count("rows", k * bs)
    sr = None
    with tracing.span("step"):
        for i in range(k):
            out = step(params, lst_t[i * bs:(i + 1) * bs], ndvi_t[i * bs:(i + 1) * bs])
            if sr is None:
                sr = out.new_empty((k * bs, fwin, fwin))
            sr[i * bs:(i + 1) * bs] = out
    with tracing.span("mosaic"):
        sr = sr[:nt]
        sr = torch.where(keep[:, None, None], sr, sr.new_zeros(()))
        mosaic = (sr.reshape(gh, gw, fwin, fwin).permute(0, 2, 1, 3)
                  .reshape(gh * fwin, gw * fwin).contiguous())
    return _to_host(mosaic)


_LINK_PROBE_CACHE: dict = {}


def _timed(fn, dev: torch.device) -> float:
    """Seconds of fn() with the device drained before and after: without the
    synchronise a CUDA transfer's time would be the time to enqueue it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def probe_link(device: str | torch.device = "cuda", refresh: bool = False, bulk_mb: int = 32):
    """Measure the host<->device link and the host once per process and
    device: the round trip of a tiny transfer and kernel, the bulk upload and
    download rates from and to pinned memory, and the rate of the host's
    tile/scatter copy (a reshape + transpose of a bulk array).

    Returns {"rtt_s", "h2d_bytes_per_s", "d2h_bytes_per_s", "host_bytes_per_s"}."""
    dev = resolve_device(device)
    key = str(dev)
    if key in _LINK_PROBE_CACHE and not refresh:
        return _LINK_PROBE_CACHE[key]
    cuda = dev.type == "cuda"

    def pinned(n):
        t = torch.zeros((n,), dtype=torch.float32)
        return t.pin_memory() if cuda else t

    tiny, buf = pinned(8), pinned(bulk_mb * 1024 * 1024 // 4)

    def round_trip():
        return float(tiny.to(dev, non_blocking=True).sum())

    round_trip()                                       # warm the dispatch path
    rtt = min(_timed(round_trip, dev) for _ in range(3))
    nbytes = buf.numel() * 4
    buf.to(dev, non_blocking=True)                     # warm the transfer path
    up = min(_timed(lambda: buf.to(dev, non_blocking=True), dev) for _ in range(2))
    dev_buf = buf.to(dev) + 0.0
    down = min(_timed(lambda: buf.copy_(dev_buf, non_blocking=True), dev) for _ in range(2))
    side = int(np.sqrt(buf.numel() // 4096)) * 64
    host = np.zeros((side, side), np.float32)

    def tile_copy():
        g = side // 64
        return np.ascontiguousarray(host.reshape(g, 64, g, 64).transpose(0, 2, 1, 3))

    tile_copy()
    t_host = min(_timed(tile_copy, torch.device("cpu")) for _ in range(2))
    _LINK_PROBE_CACHE[key] = {
        "rtt_s": rtt,
        "h2d_bytes_per_s": nbytes / max(up, 1e-9),
        "d2h_bytes_per_s": nbytes / max(down, 1e-9),
        "host_bytes_per_s": 2 * host.nbytes / max(t_host, 1e-9),   # read + write
    }
    return _LINK_PROBE_CACHE[key]


def _measure_patches_per_s(sr_step, step_params, batch_size: int, window: int, factor: int,
                           dev: torch.device) -> float:
    """Patches a second of ``sr_step`` on ``dev`` at this batch size, from one
    timed call on a constant batch after a warm-up call. The rate is kept
    on the step function itself, per shape and device, so it lives exactly
    as long as the step does."""
    rates = sr_step.__dict__.setdefault("_patches_per_s", {})
    key = (batch_size, window, factor, str(dev))
    if key not in rates:
        lst = torch.full((batch_size, window, window), 300.0, device=dev)
        ndvi = torch.full((batch_size, window * factor, window * factor), 0.5, device=dev)
        sr_step(step_params, lst, ndvi)
        t = _timed(lambda: sr_step(step_params, lst, ndvi), dev)
        rates[key] = batch_size / max(t, 1e-9)
    return rates[key]


def choose_granule_mode(lst_shape, window: int, factor: int, batch_size: int,
                        patches_per_s: float, link=None,
                        device: str | torch.device = "cuda") -> dict:
    """Pick host_pipeline vs device_tiling from measurements (the model of
    ``sifsr_tpu/inference.py::choose_granule_mode``; its two constants, a
    device rate and a host copy rate, are measured here: ``patches_per_s`` by
    the caller on its step, the host rate by ``probe_link``).

    device_tiling's wall is upload + compute + download, strictly one after
    the other, plus two dispatches. The host pipeline overlaps the per-batch
    upload/compute/download triples, so its steady state is the slowest of
    the three, plus one batch of each transfer to fill and drain, the host's
    tile/scatter copy and one dispatch round trip a batch. A tie goes to the
    pipeline: device_tiling is chosen only when predicted under 0.75 of it."""
    link = link or probe_link(device)
    gh, gw = lst_shape[0] // window, lst_shape[1] // window
    n = gh * gw
    n_batches = -(-n // batch_size)
    fwin = window * factor
    up = 4 * (gh * gw * window * window) * (1 + factor * factor)
    down = 4 * (gh * gw * fwin * fwin)
    t_up = up / link["h2d_bytes_per_s"]
    t_down = down / link["d2h_bytes_per_s"]
    t_compute = n / patches_per_s
    t_host = (up + down) / link["host_bytes_per_s"]
    t_dt = t_up + t_down + t_compute + 2 * link["rtt_s"]
    t_hp = (max(t_up, t_down, t_compute) + (t_up + t_down) / max(n_batches, 1)
            + t_host + n_batches * link["rtt_s"])
    return {
        "mode": "device_tiling" if t_dt < 0.75 * t_hp else "host_pipeline",
        "t_device_tiling_s": round(t_dt, 4),
        "t_host_pipeline_s": round(t_hp, 4),
        "rtt_s": round(link["rtt_s"], 6),
        "h2d_mb_s": round(link["h2d_bytes_per_s"] / 1e6, 1),
        "d2h_mb_s": round(link["d2h_bytes_per_s"] / 1e6, 1),
        "host_mb_s": round(link["host_bytes_per_s"] / 1e6, 1),
        "patches_per_s": round(patches_per_s, 1),
    }


class _Pipeline:
    """Keeps up to ``depth`` batches in flight and hands finished ones to
    ``consume(start, stop, sr_numpy)`` in order. On CUDA the upload, the
    compute and the download each run on their own stream, and ``submit``
    returns once they are enqueued: the caller fills the next batch while
    the card steps this one, and ``consume`` writes a finished batch out
    while the card steps a later one. A batch submitted while an earlier
    one is pending counts its rows as ``overlapped_rows``."""

    def __init__(self, device: torch.device, depth: int, consume):
        self.device, self.depth, self.consume = device, max(depth, 1), consume
        self.pending: deque = deque()
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def submit(self, start, stop, step, params, lst_b, ndvi_b):
        if tracing.enabled():
            if not self.cuda or (lst_b.is_pinned() and ndvi_b.is_pinned()):
                tracing.count("staged_rows", lst_b.shape[0])
            if self.pending:
                tracing.count("overlapped_rows", lst_b.shape[0])
        if not self.cuda:
            with tracing.span("upload"):
                lst_d, ndvi_d = _to_device(lst_b, self.device), _to_device(ndvi_b, self.device)
            with tracing.span("step"):
                self.pending.append((start, stop, step(params, lst_d, ndvi_d), None))
        else:
            compute = torch.cuda.current_stream(self.device)
            with tracing.span("upload"), torch.cuda.stream(self.h2d):
                lst_d = _to_device(lst_b, self.device)
                ndvi_d = _to_device(ndvi_b, self.device)
            with tracing.span("step"):
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
        with tracing.span("wait"):
            if done is not None:
                done.synchronize()
        with tracing.span("mosaic"):
            self.consume(start, stop, out.numpy())

    def finish(self):
        while self.pending:
            self.drain_one()


@tracing.rooted("predict_granule")
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
    device_tiling: bool = False,
    wire: str | None = None,
    pad_impl: str | None = None,
    mode: str | None = None,
    device: str | torch.device = "cuda",
    mesh=None,
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
    ndvi_batch) on the device. ``batch_size`` is the most rows a batch
    takes: a step takes any batch of 1 to ``batch_size`` rows. The host
    pipeline steps fewer than 128 blocks (origins under ``overlap``) in
    batches of ``batch_size``, the last at its own rows, unpadded; 128 or
    more as about four equal batches of at least 64 rows each (a
    324-block granule as 4 x 81), so that the host fills each batch into
    the staging while the card steps the one before, and writes each
    download into the mosaic while the card steps the one after
    (``_batches``). ``mesh`` keeps batches of ``batch_size``.

    device_tiling (overlap == 0 only): tile extraction, batching and mosaic
    assembly all run on the device: the granule is uploaded once and the
    mosaic downloaded once (two bulk transfers instead of 2·n_batches).

    wire='int' ships LST as uint16 (0.02 K/LSB, the MODIS-native encoding, so
    real granules encode losslessly), NDVI as int16 (1e-4/LSB) and the SR
    mosaic back as uint16 Kelvin/0.02: every host<->device transfer halves.
    Output error vs wire=None is bounded by the 0.01 K output rounding plus
    the model's response to <= 5e-5 NDVI rounding.

    pad_impl: conv padding of the default (bf16/float32) step, 'fused',
    'explicit' or None for ``make_sr_step``'s choice by dtype. Ignored when
    sr_step is supplied.

    mode: overrides device_tiling/wire: 'host_pipeline', 'device_tiling',
    'device_tiling_wire' or 'auto'. 'auto' measures the link, the host and
    the step once per process (``probe_link``, one timed step) and picks the
    mode ``choose_granule_mode`` favours; the decision goes to stderr. wire
    stays an explicit knob under 'auto'.

    mesh: a ``parallel.Mesh``; every rank of its group calls predict_granule
    on the same granule. ``batch_size`` must split evenly over the group.
    Every batch but the last has ``batch_size`` rows whatever the block
    count: each batch's gather is a collective, and no cell measures a
    granule split there. Each batch is split across the group's devices in
    equal shards, the last
    zero-padded only to the least multiple of the group's size at or above
    its rows: each rank uploads and runs its shard on ``mesh.device``, and
    the shards are gathered so that every rank assembles the whole mosaic. Not
    combined with ``wire='int'`` or ``device_tiling`` (``ValueError``), as in
    the JAX package; ``device`` is then ``mesh.device``.
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    fwin = window * factor
    if sr_step is None:
        sr_step = make_sr_step(stats, compute_dtype, dev, pad_impl)
        step_params = InferenceModelB2.from_variables(variables).to(dev, compute_dtype)
    if mode is not None:
        if mode == "auto":
            rate = _measure_patches_per_s(sr_step, step_params, batch_size, window, factor, dev)
            decision = choose_granule_mode(lst_granule.shape, window, factor, batch_size, rate,
                                           device=dev)
            device_tiling = decision["mode"] == "device_tiling"
            print(f"predict_granule auto mode: {decision}", file=sys.stderr)
        elif mode == "host_pipeline":
            device_tiling = False
        elif mode == "device_tiling":
            device_tiling = True
        elif mode == "device_tiling_wire":
            device_tiling, wire = True, "int"
        else:
            raise ValueError(f"mode must be host_pipeline/device_tiling/device_tiling_wire/auto, "
                             f"got {mode!r}")
    if wire not in (None, "int"):
        raise ValueError(f"wire must be None or 'int', got {wire!r}")
    if wire == "int" and mesh is not None:
        raise ValueError("wire='int' is a single-device transfer optimisation; "
                         "use wire=None with mesh")
    clip_staged = ndvi_clip
    with tracing.span("tile"):
        if ndvi_clip and (wire == "int" or device_tiling):   # they take the clipped granule
            ndvi_granule = _fresh(np.clip(ndvi_granule, -1.0, 1.0))  # predict.py:88-89
            clip_staged = False
        if wire == "int":
            lst_granule, ndvi_granule = encode_wire(lst_granule, ndvi_granule)
            lst_granule = _u16_bits(lst_granule)
            batch_step, staged, decode_out = _wire_step(sr_step, dev), torch.int16, _decode_wire_out
        else:
            batch_step, staged, decode_out = sr_step, torch.float32, np.asarray
            if device_tiling:
                lst_granule = _fresh(np.asarray(lst_granule, np.float32), lst_granule)
                ndvi_granule = _fresh(np.asarray(ndvi_granule, np.float32), ndvi_granule)
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} does not split over {mesh.size} devices")
        local_step = batch_step

        def batch_step(params, lst_b, ndvi_b):  # noqa: F811: this rank's rows in, all out
            return gather_rows(local_step(params, lst_b, ndvi_b), mesh)

    def stage(n):
        """The staging of n blocks, its rows past the blocks (a mesh's
        padding) zeroed, and the batches over it; the blocks' coverage
        flags, which ``run_batches`` sets batch by batch."""
        batches = _batches(n, batch_size, mesh)
        rows = max([n] + [b for *_, b in batches])
        lst_rows, ndvi_rows = _staging(rows, window, staged, dev), _staging(rows, fwin, staged, dev)
        lst_rows.numpy()[n:], ndvi_rows.numpy()[n:] = 0, 0
        return (lst_rows, ndvi_rows, batches), np.empty(n, bool)

    def run_batches(staging, keep, fill, consume):
        """Each batch filled into its staging rows, then submitted:
        ``fill(lst, ndvi, start, stop)`` copies blocks ``start:stop`` into
        their rows, casting as it goes; the NDVI rows are clipped in place
        (predict.py:88-89: torch's vectorised clamp on the contiguous rows
        is several times numpy's clip into a strided view, and clipping a
        float64 before or after its float32 cast gives the same float32),
        and the coverage test reads the staged LST rows."""
        lst_rows, ndvi_rows, batches = staging
        lst_np, ndvi_np = lst_rows.numpy(), ndvi_rows.numpy()
        pipe = _Pipeline(dev, pipeline_depth, consume)
        for start, stop, a, b in batches:
            with tracing.span("tile"):
                fill(lst_np, ndvi_np, start, stop)
                if clip_staged:
                    ndvi_rows[start:stop].clamp_(-1.0, 1.0)
                keep[start:stop] = _fresh(lst_np[start:stop] == 0).mean(axis=(1, 2)) <= coverage
            with tracing.span("pad"):
                lst_b, ndvi_b = lst_rows[a:b], ndvi_rows[a:b]
            tracing.count("rows", b - a)
            pipe.submit(start, stop, batch_step, step_params, lst_b, ndvi_b)
        pipe.finish()

    if device_tiling:
        if mesh is not None:
            raise ValueError("device_tiling targets single-device serving; use the host "
                             "pipeline (device_tiling=False) with mesh")
        if overlap != 0:
            raise ValueError("device_tiling does not implement overlap blending; "
                             "use the host pipeline (device_tiling=False) with overlap")
        nt = (lst_granule.shape[0] // window) * (lst_granule.shape[1] // window)
        tracing.count("blocks", nt)
        mosaic = _run_device_tiling(batch_step, step_params, lst_granule, ndvi_granule, window,
                                    factor, min(batch_size, nt), coverage, dev)
        with tracing.span("mosaic"):
            return decode_out(mosaic)

    if overlap == 0:
        gh, gw = lst_granule.shape[0] // window, lst_granule.shape[1] // window
        n = gh * gw
        with tracing.span("tile"):
            staging, keep = stage(n)
            mosaic = _fresh(np.empty((gh * fwin, gw * fwin), np.float32))
            out4 = mosaic.reshape(gh, fwin, gw, fwin)
            lst4 = lst_granule[: gh * window, : gw * window].reshape(gh, window, gw, window)
            ndvi4 = ndvi_granule[: gh * fwin, : gw * fwin].reshape(gh, fwin, gw, fwin)
        tracing.count("blocks", n)
        put_out = _put_decoded if wire == "int" else np.copyto

        def fill(lst_np, ndvi_np, start, stop):     # the cast and the layout in one pass
            for i, j, rows, cols in _grid_runs(start, stop, gw):
                np.copyto(_grid_of(lst_np[i:j], rows, cols), lst4[rows, :, cols])
                np.copyto(_grid_of(ndvi_np[i:j], rows, cols), ndvi4[rows, :, cols])

        def consume(start, stop, sr):   # a batch's download, straight into the mosaic
            for i, j, rows, cols in _grid_runs(start, stop, gw):
                put_out(out4[rows, :, cols], _grid_of(sr[i - start:j - start], rows, cols))

        run_batches(staging, keep, fill, consume)
        with tracing.span("mosaic"):
            out4.transpose(0, 2, 1, 3)[~keep.reshape(gh, gw)] = 0.0
            del staging         # the staging goes back to its allocator in this stage
        return mosaic

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

    def fill_origins(lst_np, ndvi_np, start, stop):
        for k in range(start, stop):
            y, x = origins[k]
            np.copyto(lst_np[k], lst_granule[y : y + window, x : x + window])
            np.copyto(ndvi_np[k], ndvi_granule[factor * y : factor * (y + window),
                                               factor * x : factor * (x + window)])

    with tracing.span("tile"):
        staging, keep = stage(len(origins))

        ramp = overlap * factor
        taper_1d = np.ones(fwin, np.float32)
        if ramp > 0:
            taper_1d[:ramp] = np.linspace(1.0 / (ramp + 1), 1.0, ramp, endpoint=False)
            taper_1d[-ramp:] = taper_1d[:ramp][::-1]
        taper = np.outer(taper_1d, taper_1d)

        acc = _fresh(np.zeros((h_lim * factor, w_lim * factor), np.float64))
        wacc = _fresh(np.zeros_like(acc))
    tracing.count("blocks", len(origins))

    def consume(start, stop, sr):
        sr = decode_out(sr)
        for k in range(stop - start):
            if not keep[start + k]:
                continue
            y, x = origins[start + k]
            sl = np.s_[factor * y : factor * y + fwin, factor * x : factor * x + fwin]
            acc[sl] += _fresh(sr[k] * taper)
            wacc[sl] += taper

    run_batches(staging, keep, fill_origins, consume)
    with tracing.span("mosaic"):
        del staging
        covered = _fresh(wacc > 0)
        out = _fresh(np.where(covered, _fresh(acc / _fresh(np.maximum(wacc, 1e-12))), 0.0))
        return _fresh(out.astype(np.float32))
