"""Traffic kind ``swinir_train_batches``: ``train_batches``'s pairs, batch
order, check steps and comparison, with SwinIR as the network.

The generator (``TrainPairs``: a pool of normalised 64² LST / 256² NDVI
pairs, a seeded shuffled order per epoch) and the comparison (``first_steps``,
``gaps``, ``compare``: each check step's loss, the worst leaf's first
gradient, the median leaf's change) are ``train_batches``'s own. This kind
calls ``data.datasets.prepare_batch`` and then ``train.step.make_train_step``
on a ``models.swinir.SwinIR`` back to back, as ``cli.train --params
paramsSwinIR.json`` runs a ``predef_filters`` epoch. Set-up draws the
weights from the seed with the reference's initialisation
(``reference/swinir_weights.py``) and loads them into the program; the
plain reference (``reference/swinir.py``) steps the same weights on the
same batches after the window.

Traced, the window also reduces the device time of the kernels under the
program's ``sifsr.swin.attention`` ranges (``harness/range_trace.py``).

``run`` repeats ``train_batches.run`` but for the network, its
initialisation and its reference: set-up, the faults, the control, the
window and its timers, the record, the memory released before the
reference. A change to one of the two must be made in the other too.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from sifsr_tpu_torch.models.swinir import SwinIR

from benchmark.harness import core
from benchmark.harness.range_trace import RangeTracer
from benchmark.harness.seeded import device_generator
from benchmark.reference import swinir as reference
from benchmark.reference.swinir_weights import init_state

_train = core.load_part("traffic", "train_batches")
TrainPairs, first_steps, gaps, compare = (_train.TrainPairs, _train.first_steps, _train.gaps,
                                          _train.compare)
FAULTS = _train.FAULTS
ATTENTION = "sifsr.swin.attention"


def program_state(p: dict, tc: dict, stats: dict, sd0: dict, dev):
    """The program's SwinIR, Adam and step, as ``train_loop`` builds them."""
    from sifsr_tpu_torch.train.state import create_train_state
    from sifsr_tpu_torch.train.step import make_train_step

    model = SwinIR(upscale=p["upscale"], in_chans=p["in_chans"], embed_dim=p["embed_dim"],
                   depths=tuple(p["depths"]), num_heads=tuple(p["num_heads"]),
                   window_size=p["window_size"], mlp_ratio=p["mlp_ratio"],
                   num_feat=p["num_feat"], precision=tc["precision"])
    state = create_train_state(model, tc["learning_rate"],
                               variables={k: v.clone() for k, v in sd0.items()}, device=dev)
    step = make_train_step(model, tc["recipe"], tc["alpha"], tc["gamma"], stats["mean_lst"],
                           stats["std_lst"], with_metrics=tc["step_metrics"])
    return state, step


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device: str,
        overrides: dict | None = None, control: bool = False, fault: str | None = None):
    from sifsr_tpu_torch.data.datasets import prepare_batch

    overrides = overrides or {}
    marks = {"imports": core.process_age_s()}
    cfg, dev = cell.config, torch.device(device)
    tc = {**cfg["train"], **overrides.get("train", {})}
    p = {**cfg["swinir_parameters"], **overrides.get("swinir_parameters", {})}
    cfg = {**cfg, "train": tc}
    stats = cfg["statistics"]
    pairs = TrainPairs(cell.traffic, seed, stats, tc["batch_size"], dev, overrides.get("traffic"))
    sd0 = init_state(device_generator(seed, 5, dev), dev, p)
    marks["inputs"] = core.process_age_s()
    state, step = program_state(p, tc, stats, sd0, dev)
    marks["step built"] = core.process_age_s()
    rows = slice(0, tc["batch_size"] // 2) if fault == "half_batch" else slice(None)

    def call(batch):
        batch = {k: v[rows] for k, v in batch.items()}
        before = ([w.detach().clone() for w in state.model.parameters()]
                  if fault == "unchanged" else None)
        out = step(state, prepare_batch(batch, dev))
        if before is not None:               # the step hands back its state unchanged
            with torch.no_grad():
                for w, b in zip(state.model.parameters(), before):
                    w.copy_(b)
        return out

    order = pairs.order()
    check = [pairs.batch(next(order)) for _ in range(cell.workload["check_steps"])]
    if control:   # the reference in TF32 stands in for the program's first steps
        ops = core.load_part("controls", cfg["control"]).training_ops()
        got = reference.train_steps(sd0, check, p, tc, stats, dev, ops)
        for batch in check:
            call(batch)
    else:
        got = first_steps(state, call, check, tc["adam"]["betas"][0])
    if dev.type == "cuda":
        torch.cuda.synchronize()

    rec, tracer = _train.Record(cell), RangeTracer(trace, (ATTENTION,))
    rec.swinir, rec.lr_px = p, pairs.spec["lst_px"]
    setup_s = marks["first steps"] = core.process_age_s()
    core.log(f"set-up, seconds since the process started: {marks}")
    with tracer.window():
        t0 = core.now()
        while True:
            batch = pairs.batch(next(order))
            timer = core.DeviceTimer(dev) if trace else contextlib.nullcontext()
            with timer:
                with tracer.span("prepare_batch"):
                    prepped = prepare_batch({k: v[rows] for k, v in batch.items()}, dev)
                with tracer.span("train_step"):
                    step(state, prepped)
            if trace:
                rec.step_timers.append(timer)
            rec.steps += 1
            if core.now() - t0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rec.window_s = core.now() - t0
    rec.trace = tracer.summary
    rec.samples = rec.steps * tc["batch_size"]
    core.log(f"window {rec.window_s:.3f} s: {rec.steps} steps of {tc['batch_size']}")
    if rec.trace:
        core.log(f"program ranges: {rec.trace.get('ranges')}")
    e2e = {"train_samples_per_s": rec.samples / rec.window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del state, step, prepped
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = reference.train_steps(sd0, check, p, tc, stats, dev)
    g = gaps(sd0, got, want, tc["learning_rate"])
    return {"e2e": e2e, "record": rec, "attempted": rec.steps, "failed": 0,
            "memory_peak_bytes": int(peak), "checks": compare(cfg, g), "notes": g["worst"]}
