"""Granule serving daemon: a long-running SR worker with warm kernels.

Port of ``sifsr_tpu/cli/serve.py``. The reference has no serving mode:
`predict.py` pays the model load on every granule. This daemon loads weights
once, keeps the built kernels, the serving model and the int8 calibration
across granules, and processes a spool directory of job files:

    python -m sifsr_tpu_torch.cli.serve --watch jobs/ [--pallas|--int8|--f32]

A job is a JSON file dropped into --watch:

    {"lst": "granule_lst.tif|.hdf", "ndvi": "ndvi.tif",
     "ndvi_is_precomputed": true, "out": "out/prediction.tiff"}

  - "lst"  — MOD21A1D granule (.hdf) or LST GeoTIFF in Kelvin (required);
             optional "time": "night" selects LST_Night_1km from a granule
  - "ndvi" — MOD09GQ granule (.hdf), precomputed-NDVI tif
             ("ndvi_is_precomputed": true), a chunky 2-band Red/NIR tif, or
             a NIR tif with "red" giving the Red tif
  - "out"  — output GeoTIFF path (default: <watch>/done/<job>.tiff)

Jobs are processed oldest-first (file mtime). Files modified less than a
grace window ago (half the poll interval, capped at 1 s) are left for the
next poll so producers that write in place aren't read half-written —
rename-into-place producers are picked up immediately on the next poll.
Completed job files move to <watch>/done/,
failures to <watch>/failed/ with a .err text next to them — one bad granule
never takes the worker down. `--once` drains the backlog and exits (also the
test mode); otherwise the daemon polls every --poll seconds until SIGTERM.

For --int8/--pallas the activation scales are calibrated on the first
granule's valid blocks and reused for every later granule (static
calibration). ``--device`` (default cuda) picks the torch device; cpu runs
the kernels' plain PyTorch versions.
"""

import json
import os
import shutil
import signal
import time
from argparse import ArgumentParser

import numpy as np
import torch

from sifsr_tpu_torch.cli.predict import (
    _load_lst,
    _load_ndvi,
    load_variables,
    make_quantized_step,
)
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.geo.tiff import write_geotiff
from sifsr_tpu_torch.inference import make_sr_step, predict_granule
from sifsr_tpu_torch.models.fused import InferenceModelB2

__all__ = ["main"]


class _Server:
    def __init__(self, args):
        self.args = args
        self.device = resolve_device(args.device)
        self.stats = Statistics.from_json(args.statistics)
        self.variables = load_variables(args.model_dir, args.model_name)
        self.step = None       # calibrated on the first granule (int8/pallas)
        self.step_params = None
        if not (args.int8 or args.pallas):
            # the float step and its folded model, built once for every job
            dtype = torch.float32 if args.f32 else torch.bfloat16
            self.step = make_sr_step(self.stats, dtype, self.device, args.pad_impl)
            self.step_params = InferenceModelB2.from_variables(self.variables).to(
                self.device, dtype)

    def _ensure_quantized(self, lst, ndvi):
        # calibrated once, on the first granule that has valid blocks; a
        # granule with none fails its own job with a clear error instead
        # of poisoning the daemon-lifetime calibration
        if self.step is not None:
            return
        self.step, self.step_params = make_quantized_step(
            self.variables, lst, ndvi, self.stats, self.args.pallas,
            calib_quantile=self.args.calib_quantile, device=self.device)

    def process(self, job: dict, default_out: str) -> str:
        lst, _ = _load_lst(job["lst"], time=job.get("time", "day"))
        ndvi, ndvi_gt = _load_ndvi(job["ndvi"], job.get("red"),
                                   bool(job.get("ndvi_is_precomputed")))
        a = self.args
        quantized = a.int8 or a.pallas
        if quantized:
            self._ensure_quantized(lst, ndvi)
        # coverage=0: quantized paths zero any block containing invalid (0 K)
        # pixels, as predict does
        mosaic = predict_granule(
            self.variables, lst, ndvi, self.stats,
            batch_size=a.batch_size, overlap=a.overlap,
            coverage=0.0 if quantized else 1.0,
            sr_step=self.step, step_params=self.step_params,
            device_tiling=a.device_tiling,
            wire=None if a.wire == "f32" else a.wire, device=self.device)
        out = job.get("out", default_out)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        write_geotiff(out, mosaic.astype(np.float32), geotransform=ndvi_gt,
                      geo_ascii="MODIS Sinusoidal (sphere R=6371007.181)")
        return out


def _drain(server, watch: str, log, should_stop=lambda: False,
           grace: float = 1.0) -> int:
    done_dir = os.path.join(watch, "done")
    failed_dir = os.path.join(watch, "failed")
    now = time.time()
    jobs = []
    for f in os.listdir(watch):
        path = os.path.join(watch, f)
        if not (f.endswith(".json") and os.path.isfile(path)):
            continue
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue  # raced with the producer/another consumer
        # grace window: a file modified milliseconds ago may still be being
        # written (producers that don't rename into place); pick it up on
        # the next poll rather than failing it on a half-written read
        if now - mtime < grace:
            continue
        jobs.append((mtime, f))
    jobs = [name for _, name in sorted(jobs)]  # oldest-first, as documented
    n = 0
    for name in jobs:
        if should_stop():
            break
        path = os.path.join(watch, name)
        stem = os.path.splitext(name)[0]
        t0 = time.perf_counter()
        try:
            with open(path) as f:
                job = json.load(f)
            out = server.process(job, os.path.join(done_dir, f"{stem}.tiff"))
            os.makedirs(done_dir, exist_ok=True)
            shutil.move(path, os.path.join(done_dir, name))
            log(f"[serve] {name}: wrote {out} in {time.perf_counter() - t0:.2f}s")
        except Exception as exc:  # isolate failures per job
            # the isolation path itself must not take the daemon down: a
            # second consumer (or the producer) may have moved/deleted the
            # job file between the listing and here
            try:
                os.makedirs(failed_dir, exist_ok=True)
                with open(os.path.join(failed_dir, f"{stem}.err"), "w") as f:
                    f.write(f"{type(exc).__name__}: {exc}\n")
                shutil.move(path, os.path.join(failed_dir, name))
                log(f"[serve] {name}: FAILED {type(exc).__name__}: {exc}")
            except OSError as exc2:
                log(f"[serve] {name}: FAILED ({type(exc).__name__}: {exc}) "
                    f"and could not be spooled to failed/ "
                    f"({type(exc2).__name__}: {exc2}); skipping")
        n += 1
    return n


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--watch", required=True, help="job spool directory")
    parser.add_argument("--model_dir", type=str, default="weights/modelB_1009")
    parser.add_argument("--model_name", type=str, default="modelB")
    parser.add_argument("--statistics", type=str, default="data/statistics.json")
    parser.add_argument("--batch_size", type=int, default=324)
    parser.add_argument("--overlap", type=int, default=0)
    parser.add_argument("--device-tiling", action="store_true")
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--pad-impl", default=None,
                        choices=("fused", "explicit"),
                        help="conv padding implementation for the bf16/f32 "
                             "BN-folded path (see predict --pad-impl)")
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--pallas", action="store_true")
    parser.add_argument("--calib-quantile", type=float, default=None,
                        help="int8/pallas: |x|-quantile activation-scale "
                             "clipping (default max-abs; see predict --help)")
    parser.add_argument("--wire", default="f32", choices=("f32", "int"),
                        help="host<->device transfer format (see predict "
                             "--help; 'int' halves every granule transfer)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda)")
    parser.add_argument("--poll", type=float, default=2.0,
                        help="spool poll interval (seconds)")
    parser.add_argument("--once", action="store_true",
                        help="drain the current backlog and exit")
    args = parser.parse_args(argv)

    server = _Server(args)
    os.makedirs(args.watch, exist_ok=True)
    print(f"[serve] watching {args.watch} "
          f"(path={'pallas' if args.pallas else 'int8' if args.int8 else 'f32' if args.f32 else 'bf16'})")

    stop = {"flag": False}

    def _sigterm(*_):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)

    while True:
        n = _drain(server, args.watch, print,
                   should_stop=lambda: stop["flag"],
                   grace=0.0 if args.once else min(1.0, args.poll / 2))
        if args.once:
            print(f"[serve] --once: processed {n} job(s)")
            return
        if stop["flag"]:
            print("[serve] stopping")
            return
        if n == 0:
            # sleep in short slices so SIGTERM is honoured promptly
            # (PEP 475 restarts an interrupted sleep after the handler)
            deadline = time.monotonic() + args.poll
            while not stop["flag"] and time.monotonic() < deadline:
                time.sleep(0.2)


if __name__ == "__main__":
    main()
