"""Traffic kind ``hat_train_batches``: ``train_batches``'s pairs, batch
order, check steps and comparison, with HAT as the network.

The generator (``TrainPairs``: a pool of normalised 64² LST / 256² NDVI
pairs, a seeded shuffled order per epoch) and the comparison (``first_steps``,
``gaps``, ``compare``: each check step's loss, the worst leaf's first
gradient, the median leaf's change) are ``train_batches``'s own. This kind
calls ``data.datasets.prepare_batch`` and then ``train.step.make_train_step``
on a ``models.hat.HAT`` back to back, as ``cli.train --params paramsHAT.json``
runs a ``predef_filters`` epoch. Set-up draws the weights from the seed with
the reference's initialisation (``reference/hat_weights.py``) and loads them
into the program; the plain reference (``reference/hat.py``) steps the same
weights on the same batches after the window.

Traced, the window also reduces the device time of the kernels under the
program's ``sifsr.swin.attention`` (the HABs' window attention),
``sifsr.hat.ocab_attention`` and ``sifsr.hat.cab`` ranges
(``harness/range_trace.py``). The record carries HAT's widths as ``hat``,
and as ``swinir`` the window and width that ``window_attention_roofline``
reads: the HABs' own.

Besides ``train_batches``'s faults this kind plants ``ocab_border_masked``:
every OCAB's keys and values that lie in the zero padding around the map
masked out of the softmax (-100 on their scores), where HAT lets them in
as zeros. It wraps the program's ``WindowAttentionFn`` for the run; the
program has no switch for it.

``run`` repeats ``train_batches.run``, as ``swinir_train_batches.run`` does,
but for the network, its initialisation, its reference and the fault: set-
up, the faults, the control, the window and its timers, the record, the
memory released before the reference. A change to one of the three must be
made in the others too.
"""

from __future__ import annotations

import contextlib
import gc

import torch
import torch.nn.functional as F

from sifsr_tpu_torch.models import hat as program_hat

from benchmark.harness import core
from benchmark.harness.range_trace import RangeTracer
from benchmark.harness.seeded import device_generator
from benchmark.reference import hat as reference
from benchmark.reference.hat_weights import init_state

_train = core.load_part("traffic", "train_batches")
TrainPairs, first_steps, gaps, compare = (_train.TrainPairs, _train.first_steps, _train.gaps,
                                          _train.compare)
FAULTS = (*_train.FAULTS, "ocab_border_masked")
RANGES = ("sifsr.swin.attention", "sifsr.hat.ocab_attention", "sifsr.hat.cab")
MASKED = -100.0


def program_state(p: dict, tc: dict, stats: dict, sd0: dict, dev):
    """The program's HAT, Adam and step, as ``train_loop`` builds them."""
    from sifsr_tpu_torch.train.state import create_train_state
    from sifsr_tpu_torch.train.step import make_train_step

    model = program_hat.HAT(
        upscale=p["upscale"], in_chans=p["in_chans"], embed_dim=p["embed_dim"],
        depths=tuple(p["depths"]), num_heads=tuple(p["num_heads"]),
        window_size=p["window_size"], compress_ratio=p["compress_ratio"],
        squeeze_factor=p["squeeze_factor"], conv_scale=p["conv_scale"],
        overlap_ratio=p["overlap_ratio"], mlp_ratio=p["mlp_ratio"], num_feat=p["num_feat"],
        precision=tc["precision"])
    state = create_train_state(model, tc["learning_rate"],
                               variables={k: v.clone() for k, v in sd0.items()}, device=dev)
    step = make_train_step(model, tc["recipe"], tc["alpha"], tc["gamma"], stats["mean_lst"],
                           stats["std_lst"], with_metrics=tc["step_metrics"])
    return state, step


@contextlib.contextmanager
def border_masked(p: dict, lr_px: int, dev):
    """The ``ocab_border_masked`` fault for LR grids of ``lr_px``²: the
    program's OCAB attention called with a mask of -100 on the keys its
    zero padding holds."""
    win, ow = p["window_size"], reference.overlap(p)
    pad = (ow - win) // 2
    inside = F.pad(torch.ones(lr_px, lr_px, device=dev), (pad, pad, pad, pad))
    inside = inside.unfold(0, ow, win).unfold(1, ow, win).reshape(-1, 1, ow * ow)
    mask = torch.where(inside > 0, 0.0, MASKED).expand(-1, win * win, -1).contiguous()
    real = program_hat.WindowAttentionFn

    class Masked:
        @staticmethod
        def apply(q, kv, bias, m, heads, scale, name="swin.attention"):
            if name == "hat.ocab_attention":
                m = mask
            return real.apply(q, kv, bias, m, heads, scale, name)

    program_hat.WindowAttentionFn = Masked
    try:
        yield
    finally:
        program_hat.WindowAttentionFn = real


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device: str,
        overrides: dict | None = None, control: bool = False, fault: str | None = None):
    overrides = overrides or {}
    p = {**cell.config["hat_parameters"], **overrides.get("hat_parameters", {})}
    lr_px = {**cell.traffic, **overrides.get("traffic", {})}["lst_px"]
    planted = (border_masked(p, lr_px, torch.device(device)) if fault == "ocab_border_masked"
               else contextlib.nullcontext())
    with planted:
        return _run(cell, seed, seconds, trace, device, overrides, control, fault)


def _run(cell, seed, seconds, trace, device, overrides, control, fault):
    from sifsr_tpu_torch.data.datasets import prepare_batch

    marks = {"imports": core.process_age_s()}
    cfg, dev = cell.config, torch.device(device)
    tc = {**cfg["train"], **overrides.get("train", {})}
    p = {**cfg["hat_parameters"], **overrides.get("hat_parameters", {})}
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

    rec, tracer = _train.Record(cell), RangeTracer(trace, RANGES)
    rec.hat = rec.swinir = p
    rec.lr_px = pairs.spec["lst_px"]
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
