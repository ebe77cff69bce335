"""Manifest-driven datasets and batch iterators (reference dataset.py rebuilt).

Port of ``sifsr_tpu/data/datasets.py``. Differences from the reference's
torch Datasets, by design:

- Patches are small (64² + 256² float32 ≈ 278 kB/pair), so the whole split is
  loaded once into host arrays; batches are pure numpy slices, with no
  per-item GeoTIFF reads in the hot loop (reference dataset.py:124-125
  re-reads both GeoTIFFs on every __getitem__).
- The bicubic x4 upsample and the scale-invariance degradation chain run
  on the device (``prepare_batch``, ``degrade_batch_scale_invariance``), not
  per item on the host with cv2/torch (reference dataset.py:141, 257-263).
- Iteration order is reproducible from an explicit seed.

The manifest CSV format is the reference's ModisDatasetB.csv: columns
(index, LST, NDVI, split) where LST/NDVI are GeoTIFF paths and split is
Train/Val/Test; time-of-day filtering matches the reference's filename
substring test (dataset.py:74-79). GeoTIFFs are decoded by the native
thread pool of ``data/native_loader.py`` where it is built, else by the
numpy-only reader of ``geo/tiff.py``. ``StreamingModisDataset`` keeps only
the manifest's paths and decodes each batch on demand, one batch ahead of
the consumer on a background thread.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from sifsr_tpu_torch import tracing
from sifsr_tpu_torch.data.native_loader import _read_band1, load_batch, native_available
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.geo.tiff import read_geotiff
from sifsr_tpu_torch.kernels.fused_ops import fused_norm_l4
from sifsr_tpu_torch.ops.psf import downscale_lst_sr_to_lr_test
from sifsr_tpu_torch.ops.resize import upsample_bicubic

__all__ = [
    "normalize",
    "denormalize",
    "ArrayDataset",
    "ModisDataset",
    "StreamingModisDataset",
    "prepare_batch",
    "degrade_batch_scale_invariance",
    "make_synthetic_dataset",
]


def normalize(lst: np.ndarray, ndvi: np.ndarray, stats: Statistics, transf: str = "norm"):
    """The reference's three normalisation modes (dataset.py:127-139)."""
    if transf == "norm":
        return (lst - stats.mean_lst) / stats.std_lst, (ndvi - stats.mean_ndvi) / stats.std_ndvi
    if transf == "0-1":
        return lst / stats.maxi, ndvi
    if transf == "-1_1":
        return 2.0 * (lst / stats.maxi - 0.5), ndvi
    raise ValueError(f"unknown transf {transf!r}")


def denormalize(lst: np.ndarray, stats: Statistics, transf: str = "norm"):
    if transf == "norm":
        return lst * stats.std_lst + stats.mean_lst
    if transf == "0-1":
        return lst * stats.maxi
    if transf == "-1_1":
        return (lst / 2.0 + 0.5) * stats.maxi
    raise ValueError(f"unknown transf {transf!r}")


class ArrayDataset:
    """In-memory dataset of normalised (lst, ndvi) pairs with batch iteration.

    lst: (M, 64, 64) float32 (normalised); ndvi: (M, 256, 256) float32.
    Yields NHWC batch dicts {'lst', 'ndvi'} of numpy arrays; the device-side
    prep step adds 'lst_up' (and the scale-invariance degradation when
    requested).
    """

    def __init__(self, lst: np.ndarray, ndvi: np.ndarray, stats: Statistics):
        assert lst.shape[0] == ndvi.shape[0]
        self.lst = np.ascontiguousarray(lst, dtype=np.float32)
        self.ndvi = np.ascontiguousarray(ndvi, dtype=np.float32)
        self.stats = stats

    def __len__(self) -> int:
        return self.lst.shape[0]

    def batches(
        self, batch_size: int, seed: int | None = None, drop_remainder: bool = True
    ) -> Iterator[dict]:
        order = np.arange(len(self))
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        stop = len(self) - batch_size + 1 if drop_remainder else len(self)
        for start in range(0, max(stop, 0), batch_size):
            idx = order[start : start + batch_size]
            yield {
                "lst": self.lst[idx][..., None],
                "ndvi": self.ndvi[idx][..., None],
            }

    def n_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        if drop_remainder:
            return len(self) // batch_size
        return -(-len(self) // batch_size)


def _read_manifest(csv_path: str, split: str, time: str) -> tuple[list[str], list[str]]:
    """The LST and NDVI paths of one split, filtered by time of day."""
    import csv as csv_mod

    lst_paths, ndvi_paths = [], []
    with open(csv_path, newline="") as f:
        for row in csv_mod.DictReader(f):
            if row.get("split") != split:
                continue
            if time != "Both" and time not in row["LST"]:
                continue
            lst_paths.append(row["LST"])
            ndvi_paths.append(row["NDVI"])
    return lst_paths, ndvi_paths


class ModisDataset(ArrayDataset):
    """ArrayDataset loaded from a reference-format manifest CSV."""

    def __init__(
        self,
        csv_path: str,
        stats: Statistics,
        split: str = "Train",
        time: str = "Both",
        transf: str = "norm",
    ):
        lst_paths, ndvi_paths = _read_manifest(csv_path, split, time)
        # decode through the native thread pool where it is built, else the
        # pure-Python reader
        if lst_paths and native_available():
            lst = load_batch(lst_paths, 64, 64)
            ndvi = load_batch(ndvi_paths, 256, 256)
        else:
            lst = (np.stack([_read_band1(p) for p in lst_paths]) if lst_paths
                   else np.zeros((0, 64, 64), np.float32))
            ndvi = (np.stack([_read_band1(p) for p in ndvi_paths]) if ndvi_paths
                    else np.zeros((0, 256, 256), np.float32))
        lst, ndvi = normalize(lst.astype(np.float32), ndvi.astype(np.float32), stats, transf)
        super().__init__(lst, ndvi, stats)
        self.paths = list(zip(lst_paths, ndvi_paths))
        self.transf = transf


def _to_device(batch: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


@tracing.rooted("prepare_batch")
@torch.no_grad()
def prepare_batch(batch: dict, device: str | torch.device = "cuda") -> dict:
    """Device-side prep for the standard recipes: move the batch (numpy
    arrays or tensors) to ``device`` and add the bicubic x4 LST upsample as a
    model input channel (reference dataset.py:141, but on the device instead
    of per-item cv2 on the host).

    Under ``tracing``: a ``prepare_batch`` root with the spans ``upload``
    (the pageable host-to-device copy) and, on CUDA with host arrays in the
    batch, ``wait``: the copy waits for the stream's queued work anyway, so
    under tracing the stream is synchronised just before it, to give that
    wait a span of its own."""
    dev = resolve_device(device)
    if dev.type == "cuda" and tracing.enabled() and any(
            not torch.is_tensor(v) or v.device.type == "cpu" for v in batch.values()):
        with tracing.span("wait"):
            torch.cuda.current_stream(dev).synchronize()
    with tracing.span("upload"):
        batch = _to_device(batch, dev)
    lst = batch["lst"]
    lst_up = upsample_bicubic(lst.movedim(-1, 1), 4).movedim(1, -1)
    return {"lst": lst, "lst_up": lst_up, "ndvi": batch["ndvi"]}


@torch.no_grad()
def degrade_batch_scale_invariance(batch: dict, mean_lst: float, std_lst: float,
                                   device: str | torch.device = "cuda") -> dict:
    """Device-side scale-invariance degradation (reference dataset.py:257-263,
    quirks preserved, see ops.psf.downscale_lst_sr_to_lr_test):

      ndvi_1km   = pad+bicubic/4+crop of the 250 m NDVI      (256 -> 64)
      lst_4km    = norm-L4 pool of the un-normalised 1 km LST (64 -> 16)
      lst_4km_up = cv2-bicubic x4 of lst_4km, re-normalised   (16 -> 64)

    Returns {'lst_up': lst_4km_up, 'ndvi': ndvi_1km, 'lst': lst_1km}: the
    model learns 4 km -> 1 km against the real 1 km LST.
    """
    batch = _to_device(batch, device)
    lst = batch["lst"].movedim(-1, 1)    # (N,1,64,64), normalised
    ndvi = batch["ndvi"].movedim(-1, 1)  # (N,1,256,256), normalised

    ndvi_1km = downscale_lst_sr_to_lr_test(ndvi, deci_type="bic")
    # un-normalise + norm-L4 pool is fused_norm_l4's function: its kernel on a
    # CUDA tensor, on a CPU tensor its plain version, which is the JAX
    # package's downscale_lst_sr_to_lr_test(lst*std + mean, deci_type="norm-L4")
    lst_4km = fused_norm_l4(lst[:, 0].contiguous(), mean_lst, std_lst, factor=4)[:, None]
    lst_4km_up = upsample_bicubic(lst_4km, 4)
    lst_4km_up = (lst_4km_up - mean_lst) / std_lst

    return {
        "lst_up": lst_4km_up.movedim(1, -1),
        "ndvi": ndvi_1km.movedim(1, -1),
        "lst": batch["lst"],
    }


def make_synthetic_dataset(
    n: int, stats: Statistics | None = None, seed: int = 0
) -> ArrayDataset:
    """Deterministic synthetic LST/NDVI pairs for smoke tests and benches:
    smooth anticorrelated fields with realistic dynamic ranges. Pure numpy
    from the seed: the same arrays as the JAX package's function."""
    rng = np.random.default_rng(seed)
    stats = stats or Statistics(
        maxi=330.0, mini=260.0, mean_lst=295.0, std_lst=10.0, mean_ndvi=0.3, std_ndvi=0.25
    )
    # low-frequency structure via frequency-domain shaping
    freqs_y = np.fft.fftfreq(256)[:, None]
    freqs_x = np.fft.fftfreq(256)[None, :]
    spectrum_shape = 1.0 / (1e-3 + np.hypot(freqs_y, freqs_x) ** 1.5)

    lst_list, ndvi_list = [], []
    for _ in range(n):
        phases = np.exp(2j * np.pi * rng.random((256, 256)))
        field = np.real(np.fft.ifft2(spectrum_shape * phases))
        field = (field - field.mean()) / (field.std() + 1e-9)
        ndvi = np.clip(0.3 + 0.25 * field, -1, 1).astype(np.float32)
        noise = rng.normal(size=(64, 64)).astype(np.float32)
        lst = (295.0 - 8.0 * field[::4, ::4] + 0.5 * noise).astype(np.float32)
        lst_list.append(lst)
        ndvi_list.append(ndvi)

    lst, ndvi = normalize(np.stack(lst_list), np.stack(ndvi_list), stats, "norm")
    return ArrayDataset(lst, ndvi, stats)


class StreamingModisDataset:
    """Out-of-core manifest dataset: per-batch decode through the native
    thread pool with background prefetch.

    ModisDataset materialises every patch at construction, which suits the
    reference-sized corpora (a few GB) but not a manifest larger than host
    RAM. This variant keeps only the path lists and decodes each shuffled
    batch on demand in the native loader's pthread pool, one batch ahead of
    the consumer on a background thread, so that decode overlaps the device's
    work.

    Same iteration contract as ArrayDataset.batches (shuffled per seed,
    drop_remainder, {'lst','ndvi'} NHWC numpy dicts): ``train.loop`` takes it
    unchanged.
    """

    def __init__(self, csv_path: str, stats: Statistics, split: str = "Train",
                 time: str = "Both", transf: str = "norm",
                 n_threads: int = 8, prefetch: int = 2):
        self.lst_paths, self.ndvi_paths = _read_manifest(csv_path, split, time)
        self.stats = stats
        self.transf = transf
        self.n_threads = n_threads
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.lst_paths)

    def n_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        if drop_remainder:
            return len(self) // batch_size
        return -(-len(self) // batch_size)

    def _decode(self, idx: np.ndarray) -> dict:
        lp = [self.lst_paths[i] for i in idx]
        np_ = [self.ndvi_paths[i] for i in idx]
        if native_available():
            lst = load_batch(lp, 64, 64, n_threads=self.n_threads)
            ndvi = load_batch(np_, 256, 256, n_threads=self.n_threads)
        else:
            lst = np.stack([read_geotiff(p).array for p in lp])
            ndvi = np.stack([read_geotiff(p).array for p in np_])
        lst, ndvi = normalize(lst.astype(np.float32), ndvi.astype(np.float32),
                              self.stats, self.transf)
        return {"lst": lst[..., None], "ndvi": ndvi[..., None]}

    def batches(self, batch_size: int, seed: int | None = None,
                drop_remainder: bool = True) -> Iterator[dict]:
        import queue
        import threading

        order = np.arange(len(self))
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        stop = len(self) - batch_size + 1 if drop_remainder else len(self)
        starts = list(range(0, max(stop, 0), batch_size))

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop_event = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop_event.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for s0 in starts:
                    if stop_event.is_set():
                        return
                    if not put(self._decode(order[s0 : s0 + batch_size])):
                        return
            except Exception as exc:  # a decode error is raised in the consumer
                put(exc)
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # the consumer left the epoch (break, exception, close): unblock
            # and retire the producer instead of leaving it on a full queue
            stop_event.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
