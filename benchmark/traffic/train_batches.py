"""Traffic kind ``train_batches``: the training cells' generator and driver.

The generator makes ``pool_pairs`` normalised 64² LST / 256² NDVI pairs
from the seed and hands out batches in a seeded shuffled order per epoch
over the pool (``order``: ``shuffled_epochs``).

The driver calls ``train.step.make_train_step`` back to back on host
batches that ``data.datasets.prepare_batch`` moves to the device and
completes with the cubic x4 input channel, as ``train.loop.train_loop``
runs a ``predef_filters`` epoch.

Set-up builds one state (model, Adam) from weights drawn from the seed,
and drives it through its first ``check_steps`` steps (the cell's
``workloads/<cell>.json``) with the window's own call and feed; the
window then goes on with the same state. After the window
the plain reference takes the same weights and the same batches,
and the two are compared: each step's loss, the norm of each leaf's first
gradient as Adam got it (its first moment after one step over 1 - beta1),
the worst leaf's gap, and the norm of each leaf's change over those steps,
the median leaf's gap. The worst leaf's gap of change norms is logged
beside it and not compared: Adam's first steps move an element by about
the learning rate whatever its gradient, so an element whose gradient lies
within round-off of zero turns its step by round-off alone, and a few such
elements in a leaf of some hundred swing that leaf's norm from seed to seed.
"""

from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from benchmark.harness import core
from benchmark.harness.seeded import PAIR_FREQS, device_generator, fields, rng
from benchmark.harness.trace import Tracer
from benchmark.reference.train import train_steps
from benchmark.reference.weights import init_state

# the planted faults of this kind (for the harness's tests and control.py)
FAULTS = ("half_batch", "unchanged")
# a leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone under Adam: left out of the comparison
NEGLIGIBLE_GRAD = 1e-3


class TrainPairs:
    """The pool of normalised training pairs and the batch sequence."""

    def __init__(self, spec: dict, seed: int, stats: dict, batch_size: int, device,
                 overrides=None):
        spec = {**spec, **(overrides or {})}
        self.spec, self.batch_size = spec, batch_size
        n, px, f = spec["pool_pairs"], spec["lst_px"], spec["factor"]
        if n < batch_size:
            raise ValueError(f"a pool of {n} pairs holds no batch of {batch_size}")
        dev = torch.device(device)
        gen = device_generator(seed, 3, dev)
        field = fields(gen, n, f * px, PAIR_FREQS, dev)
        ndvi = (0.45 + 0.25 * field).clamp_(0.1, 0.8)
        ndvi += 0.02 * torch.randn(ndvi.shape, generator=gen, device=dev)
        # anticorrelated with the NDVI, as vegetation cools the surface
        lst = 305.0 - 8.0 * field[:, ::f, ::f] + 0.5 * torch.randn((n, px, px), generator=gen,
                                                                   device=dev)
        lst = (lst - stats["mean_lst"]) / stats["std_lst"]
        ndvi = (ndvi - stats["mean_ndvi"]) / stats["std_ndvi"]
        self.lst = np.ascontiguousarray(lst.cpu().numpy(), np.float32)
        self.ndvi = np.ascontiguousarray(ndvi.cpu().numpy(), np.float32)
        self._seed = seed

    def order(self, stream: int = 4):
        """Row indices of the run's batches, in order, forever; every batch
        of an epoch holds rows no other batch of the epoch holds."""
        if self.spec["order"] != "shuffled_epochs":
            raise ValueError(f"unknown order {self.spec['order']!r}")
        r = rng(self._seed, stream)
        n, b = len(self.lst), self.batch_size
        while True:
            perm = r.permutation(n)
            for start in range(0, n - b + 1, b):
                yield perm[start:start + b]

    def batch(self, idx) -> dict:
        """A host batch as ``ArrayDataset.batches`` yields it: NHWC numpy."""
        return {"lst": self.lst[idx][..., None], "ndvi": self.ndvi[idx][..., None]}


class Record:
    def __init__(self, cell: core.Cell):
        self.cell = cell
        self.window_s = 0.0
        self.steps = 0
        self.samples = 0
        self.step_timers: list = []
        self.trace: dict | None = None


def program_state(cfg: dict, sd0: dict, dev):
    """The program's model, Adam and step, as ``train_loop`` builds them."""
    from sifsr_tpu_torch.models.unet import ModelB2
    from sifsr_tpu_torch.train.state import create_train_state
    from sifsr_tpu_torch.train.step import make_train_step

    mp, tc, st = cfg["modelB_parameters"], cfg["train"], cfg["statistics"]
    model = ModelB2(in_channels=mp["in_channels"], downchannels=tuple(mp["downchannels"]),
                    padding_mode=mp["padding_mode"], precision=tc["precision"],
                    bilinear=bool(mp["bilinear"]), dtype=torch.float32, pad_impl=tc["pad_impl"])
    sd = {k: v.clone() for k, v in sd0.items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    state = create_train_state(model, tc["learning_rate"], variables=sd, device=dev)
    step = make_train_step(model, tc["recipe"], tc["alpha"], tc["gamma"], st["mean_lst"],
                           st["std_lst"], with_metrics=tc["step_metrics"])
    return state, step


def first_steps(state, call, batches, beta1: float):
    """Run the check steps through ``call``; (losses, first gradients,
    parameters after the last), read off the state before anything else
    moves it."""
    losses, grad1 = [], None
    for t, batch in enumerate(batches, 1):
        _, metrics = call(batch)
        losses.append(metrics["loss"])
        if t == 1:
            grad1 = {n: state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                     for n, p in state.model.named_parameters()}
    after = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    return [float(v) for v in losses], grad1, after


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device: str,
        overrides: dict | None = None, control: bool = False, fault: str | None = None):
    from sifsr_tpu_torch.data.datasets import prepare_batch

    overrides = overrides or {}
    marks = {"imports": core.process_age_s()}
    cfg, dev = cell.config, torch.device(device)
    tc = {**cfg["train"], **overrides.get("train", {})}
    cfg = {**cfg, "train": tc}
    pairs = TrainPairs(cell.traffic, seed, cfg["statistics"], tc["batch_size"], dev,
                       overrides.get("traffic"))
    mp = cfg["modelB_parameters"]
    sd0 = init_state(device_generator(seed, 5, dev), dev, mp["in_channels"],
                     tuple(mp["downchannels"]))
    marks["inputs"] = core.process_age_s()
    state, step = program_state(cfg, sd0, dev)
    marks["step built"] = core.process_age_s()
    rows = slice(0, tc["batch_size"] // 2) if fault == "half_batch" else slice(None)

    def call(batch):
        batch = {k: v[rows] for k, v in batch.items()}
        before = ([p.detach().clone() for p in state.model.parameters()]
                  if fault == "unchanged" else None)
        out = step(state, prepare_batch(batch, dev))
        if before is not None:               # the step hands back its state unchanged
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
        return out

    order = pairs.order()
    check = [pairs.batch(next(order)) for _ in range(cell.workload["check_steps"])]
    beta1 = tc["adam"]["betas"][0]
    if control:   # the reference in TF32 stands in for the program's first steps
        ops = core.load_part("controls", cfg["control"]).training_ops()
        got = train_steps(sd0, check, tc, cfg["statistics"], dev, ops)
        for batch in check:
            call(batch)
    else:
        got = first_steps(state, call, check, beta1)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    rec, tracer = Record(cell), Tracer(trace)
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
    e2e = {"train_samples_per_s": rec.samples / rec.window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del state, step, prepped
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = train_steps(sd0, check, tc, cfg["statistics"], dev)
    g = gaps(sd0, got, want, tc["learning_rate"])
    return {"e2e": e2e, "record": rec, "attempted": rec.steps, "failed": 0,
            "memory_peak_bytes": int(peak), "checks": compare(cfg, g), "notes": g["worst"]}


def gaps(sd0, got, want, lr: float) -> dict:
    """The compared numbers of one run (see the module docstring), and what
    the log shows of the change's worst leaf."""
    loss_got, grad_got, after_got = got
    loss_want, grad_want, after_want = want
    gw = {n: float(g.norm()) for n, g in grad_want.items()}
    med = float(np.median(list(gw.values())))
    kept = [n for n in gw if gw[n] >= NEGLIGIBLE_GRAD * med]

    def by_leaf(norm_got, norm_want):
        floor = float(np.median([norm_want[n] for n in kept]))
        return {n: abs(norm_got[n] - norm_want[n]) / max(norm_want[n], floor) for n in kept}

    def worst(leaf_gaps):
        return max((v, n) for n, v in leaf_gaps.items())

    grad, grad_leaf = worst(by_leaf({n: float(grad_got[n].norm()) for n in kept}, gw))
    du_got = {n: float((after_got[n] - sd0[n]).norm()) for n in kept}
    du_want = {n: float((after_want[n] - sd0[n]).norm()) for n in kept}
    du_gaps = by_leaf(du_got, du_want)
    update, update_leaf = worst(du_gaps)
    # elements whose three steps differ by more than half a step: their
    # first gradient against the median element's of the leaf
    off = (after_got[update_leaf] - after_want[update_leaf]).abs() > 0.5 * lr
    g1 = grad_want[update_leaf].abs()
    turned = sorted(float(v) for v in g1[off] / g1.median().clamp_min(1e-30))[-10:]
    steps = [abs(a - b) / abs(b) for a, b in zip(loss_got, loss_want)]
    return {"loss_rel_gap": max(steps), "grad_norm_gap": grad,
            "update_norm_gap_median": float(np.median(list(du_gaps.values()))),
            "left_out": sorted(set(gw) - set(kept)),
            "worst": {"loss_by_step": steps, "grad_leaf": grad_leaf,
                      "update_norm_gap_worst": update, "update_leaf": update_leaf,
                      "update_leaf_size": int(g1.numel()),
                      "turned_elements": int(off.sum()),
                      "turned_grad_over_median_largest": turned,
                      "turned_elements_whole_model": int(sum(
                          int(((after_got[n] - after_want[n]).abs() > 0.5 * lr).sum())
                          for n in kept))}}


def compare(cfg, g: dict) -> list[core.Check]:
    if g["left_out"]:
        core.log(f"leaves left out (reference gradient under {NEGLIGIBLE_GRAD} of the median "
                 f"leaf's): {g['left_out']}")
    core.log(f"worst: {g['worst']}")
    lim = cfg["train_accuracy"]
    return [core.Check(k, g[k], lim[k]) for k in ("loss_rel_gap", "grad_norm_gap",
                                                  "update_norm_gap_median")]
