"""Traffic kind ``areas``: the serving cells' generator and driver.

The generator cuts requests of LST/NDVI areas from a pool of synthetic
MODIS granules (``pool_granules`` of ``granule_lst_px``² 1 km LST with the
``factor``x NDVI). Each request is one of ``areas_lst_px`` ([rows, cols] in
LST pixels) at a seeded offset in a pool granule. ``order``: ``cycle``
takes the areas and the granules in turn; ``shuffled_rounds`` takes the
areas in rounds, each round a seeded permutation of all of them, so every
seed sends the same sizes in another order. One client sends them in a
closed loop.

The driver calls ``inference.predict_granule`` as ``cli.serve``'s
``_Server.process`` does (the step built once, ``batch_size`` and
``coverage`` from the configuration, ``overlap=0``, the default host
pipeline, ``wire=None``), then compares a seeded sample of the window's
mosaics with the plain reference. The configuration's ``serve.step`` names
the step's file, ``benchmark/steps/<step>.py``, and its ``control`` the
control's, ``benchmark/controls/<control>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import core
from benchmark.harness.seeded import device_generator, granule, rng
from benchmark.harness.trace import Tracer
from benchmark.reference.modelb2 import Ops, predict_area, serve_blocks
from benchmark.reference.weights import load_msgpack_state

# the planted faults of this kind (for the harness's tests and control.py)
FAULTS = ("half_batch", "altered")

WARM_ROUNDS = 2


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    granule: int
    y: int            # offset in LST pixels
    x: int
    h: int            # size in LST pixels
    w: int

    def blocks(self, lst_block: int) -> int:
        return (self.h // lst_block) * (self.w // lst_block)


class Areas:
    """The pool of granules and the endless request sequence of one run."""

    def __init__(self, spec: dict, seed: int, factor: int, device, overrides=None):
        spec = {**spec, **(overrides or {})}
        if spec["loop"] != "closed" or spec["clients"] != 1:
            raise ValueError("the generator sends a closed loop of one client")
        self.spec, self.factor = spec, factor
        gen = device_generator(seed, 1, torch.device(device))
        px = spec["granule_lst_px"]
        self.pool = [granule(gen, px, factor, device) for _ in range(spec["pool_granules"])]
        self.areas = [tuple(a) for a in spec["areas_lst_px"]]
        for h, w in self.areas:
            if h > px or w > px:
                raise ValueError(f"area {h}x{w} does not fit a {px}² granule")
        self._seed = seed

    def requests(self, stream: int = 2):
        """The run's requests, in order, forever."""
        r = rng(self._seed, stream)
        order, px, i = self.spec["order"], self.spec["granule_lst_px"], 0
        while True:
            if order == "cycle":
                sizes = self.areas
            elif order == "shuffled_rounds":
                sizes = [self.areas[k] for k in r.permutation(len(self.areas))]
            else:
                raise ValueError(f"unknown order {order!r}")
            for h, w in sizes:
                g = i % len(self.pool) if order == "cycle" else int(r.integers(len(self.pool)))
                y = 0 if h == px else int(r.integers(0, px - h + 1))
                x = 0 if w == px else int(r.integers(0, px - w + 1))
                yield Request(i, g, y, x, h, w)
                i += 1

    def inputs(self, req: Request):
        """(lst, ndvi) of a request: views into the pool."""
        lst, ndvi = self.pool[req.granule]
        f = self.factor
        return (lst[req.y:req.y + req.h, req.x:req.x + req.w],
                ndvi[f * req.y:f * (req.y + req.h), f * req.x:f * (req.x + req.w)])


class Record:
    """What the window leaves for the per-layer readers."""

    def __init__(self, cell: core.Cell):
        self.cell = cell
        self.window_s = 0.0
        self.requests: list[dict] = []     # blocks, seconds, step_s of each request
        self.step_calls: list[tuple] = []  # (rows, DeviceTimer) of each traced step
        self.launches: dict = {}
        self.trace: dict | None = None
        self.samples = 0                   # blocks served in the window


def control_step(cfg, calib, dev):
    """The reference in the program's place, one precision below the
    configuration's (``benchmark/controls/<control>.py``)."""
    sd = load_msgpack_state(str(core.ROOT / cfg["weights"]), dev)
    stats = cfg["statistics"]
    ops = core.load_part("controls", cfg["control"]).serving_ops(cfg, sd, calib, dev)

    def step(params, lst_b, ndvi_b):
        return serve_blocks(sd, stats, torch.as_tensor(lst_b, device=dev),
                            torch.as_tensor(ndvi_b, device=dev), ops)
    return step, None


def fault_step(step, fault: str):
    """A planted fault (for the harness's own tests)."""
    def broken(params, lst_b, ndvi_b):
        out = step(params, lst_b, ndvi_b)
        if fault == "half_batch":              # every other row of the batch left out
            out = out.clone()
            out[1::2] = 0
        elif fault == "altered":               # one answer altered: two blocks swapped
            out = out.clone()
            out[[0, 1]] = out[[1, 0]]
        else:
            raise ValueError(fault)
        return out
    return broken


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device: str,
        overrides: dict | None = None, control: bool = False, fault: str | None = None):
    from sifsr_tpu_torch import kernels
    from sifsr_tpu_torch.cli.predict import load_variables
    from sifsr_tpu_torch.data.statistics import Statistics
    from sifsr_tpu_torch.inference import predict_granule

    overrides = overrides or {}
    marks = {"imports": core.process_age_s()}
    cfg, dev = cell.config, torch.device(device)
    cfg = {**cfg, "serve": {**cfg["serve"], **overrides.get("serve", {})}}
    serve_cfg, block = cfg["serve"], cfg["lst_block"]
    stats = Statistics(**cfg["statistics"])
    areas = Areas(cell.traffic, seed, cfg["factor"], dev, overrides.get("traffic"))
    calib = areas.pool[0]   # calibrated once, on the first granule, as cli.serve does
    marks["inputs"] = core.process_age_s()
    weights = Path(core.ROOT / cfg["weights"])
    variables = load_variables(str(weights.parent), weights.name.split("_variables")[0])
    step, params = (control_step(cfg, calib, dev) if control else
                    core.load_part("steps", serve_cfg["step"]).build(cfg, stats, variables,
                                                                     calib, dev))
    marks["step built"] = core.process_age_s()
    if fault:
        step = fault_step(step, fault)

    rec, tracer = Record(cell), Tracer(trace)
    timed = step
    if trace:
        def timed(p, lst_b, ndvi_b):
            with tracer.span("sr_step"), core.DeviceTimer(dev) as t:
                out = step(p, lst_b, ndvi_b)
            rec.step_calls.append((int(lst_b.shape[0]), t))
            return out

    def call(req, fn):
        lst, ndvi = areas.inputs(req)
        return predict_granule(variables, lst, ndvi, stats, batch_size=serve_cfg["batch_size"],
                               coverage=serve_cfg["coverage"], overlap=0, sr_step=fn,
                               step_params=params, wire=None, device=dev)

    requests = areas.requests()
    warm = dict.fromkeys(areas.areas, 0)         # every area size, WARM_ROUNDS times
    for req in areas.requests(stream=9):
        if warm[(req.h, req.w)] < WARM_ROUNDS:
            warm[(req.h, req.w)] += 1
            call(req, step)
        if min(warm.values()) >= WARM_ROUNDS:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()

    k = cell.workload.get("check_requests")
    sampler = rng(seed, 7)
    kept: list = []            # a uniform seeded sample of k requests (reservoir)
    kernels.reset_launches()
    setup_s = marks["warm-up"] = core.process_age_s()
    core.log(f"set-up, seconds since the process started: {marks}")
    n_done = 0
    with tracer.window():
        t0 = core.now()
        for req in requests:
            first = len(rec.step_calls)
            r0 = core.now()
            with tracer.span("request"):
                mosaic = call(req, timed)
            r1 = core.now()
            rec.requests.append({"blocks": req.blocks(block), "seconds": r1 - r0,
                                 "steps": (first, len(rec.step_calls))})
            if k is None or len(kept) < k:
                kept.append((req, mosaic))
            else:
                j = int(sampler.integers(n_done + 1))
                if j < k:
                    kept[j] = (req, mosaic)
            n_done += 1
            if r1 - t0 >= seconds:
                break
        rec.window_s = r1 - t0
    rec.trace = tracer.summary
    rec.launches = {kk.__name__: kk.launches for kk in kernels.KERNELS if kk.launches}
    rec.samples = sum(r["blocks"] for r in rec.requests)
    for r in rec.requests:
        a, b = r["steps"]
        times = [t.seconds() for _, t in rec.step_calls[a:b]]
        r["step_s"] = sum(times) if times and None not in times else None
    lat = np.asarray([r["seconds"] for r in rec.requests])
    core.log(f"window {rec.window_s:.3f} s: {len(lat)} requests, {rec.samples} blocks; request "
             f"ms median {np.median(lat) * 1e3:.3f}, p95 {np.percentile(lat, 95) * 1e3:.3f}; "
             f"launches per request "
             f"{ {n: c / len(lat) for n, c in rec.launches.items()} }")
    e2e = {"patches_per_s": rec.samples / rec.window_s,
           "request_p95_ms": float(np.percentile(lat, 95)) * 1e3,
           "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the program's state goes before the reference runs
    del step, timed, params, variables
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cfg, areas, kept, dev)
    return {"e2e": e2e, "record": rec, "attempted": len(rec.requests), "failed": 0,
            "memory_peak_bytes": int(peak), "checks": checks}


def compare(cfg: dict, areas: Areas, kept: list, dev) -> list[core.Check]:
    """RMSE and largest gap (K) of the kept mosaics against the float32
    reference on the same inputs, over every pixel of them."""
    sd = load_msgpack_state(str(core.ROOT / cfg["weights"]), dev)
    sq, n, worst = 0.0, 0, 0.0
    for req, mosaic in kept:
        lst, ndvi = areas.inputs(req)
        ref = predict_area(sd, cfg["statistics"], lst, ndvi, cfg["serve"]["coverage"], dev,
                           Ops(), cfg["lst_block"], cfg["factor"])
        if mosaic.shape != ref.shape:
            return [core.Check("shape_mismatch", float("inf"), 0.0)]
        d = mosaic.astype(np.float64) - ref
        sq += float(np.square(d).sum())
        n += d.size
        worst = max(worst, float(np.abs(d).max()))
    acc = cfg["accuracy"]
    return [core.Check("rmse_K", (sq / max(n, 1)) ** 0.5, acc["rmse_K"]),
            core.Check("max_abs_K", worst, acc["max_abs_K"])]

