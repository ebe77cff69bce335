"""The traced window: ``torch.profiler`` over the whole measured window,
with the benchmark's own spans (``record_function``) around its calls into
the program, reduced to device busy time, device operations by name and
idle gaps labelled by the benchmark span open on the host at the time.

Spans: ``window`` (the measured window), ``request`` (one
``predict_granule`` call), ``sr_step`` (one serving step inside it),
``prepare_batch`` and ``train_step`` (one training step's two calls).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

SPANS = ("window", "request", "sr_step", "prepare_batch", "train_step")


class Tracer:
    """A no-op unless ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.summary: dict | None = None

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.enabled else contextlib.nullcontext()

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        try:
            with torch.profiler.record_function("window"):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self._prof.__exit__(None, None, None)
        self.summary = reduce_events(_raw_events(self._prof))
        self._prof = None


def _raw_events(prof) -> list[tuple]:
    """(name, on_device, is_annotation, start_ns, end_ns) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        ann = e.is_user_annotation()
        out.append((e.name(), e.device_type() != torch.autograd.DeviceType.CPU, ann,
                    e.start_ns(), e.end_ns()))
    return out


def _union(intervals):
    """Merged, sorted, disjoint [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce_events(events) -> dict:
    """The reduction of one traced window, in seconds:
    ``window_s`` (the ``window`` span), ``busy_s`` (the union of device
    activity inside it), ``kernels`` ({name: [count, seconds]} of device
    operations), ``idle`` ({label: seconds} of the window's idle device
    time, by the innermost benchmark span open on the host at each gap's
    middle) and ``spans`` ({name: count})."""
    host = defaultdict(list)
    device = []
    for name, on_device, ann, s, e in events:
        if on_device and not ann:
            device.append((s, e, name))
        elif ann and not on_device and name in SPANS:
            host[name].append((s, e))
    if not host["window"]:
        return {}
    w0, w1 = host["window"][0]
    kernels: dict = defaultdict(lambda: [0, 0.0])
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) * 1e-9
    busy = _union(clipped)
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < w1:
        gaps.append((at, w1))
    order = [n for n in SPANS if n != "window"]
    starts = {n: sorted(host[n]) for n in order}
    keys = {n: [s for s, _ in starts[n]] for n in order}
    idle: dict = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        label = "window"
        for n in order:          # outer spans first: the last match is the innermost
            i = bisect.bisect_right(keys[n], mid) - 1
            if i >= 0 and starts[n][i][1] >= mid:
                label = n if label == "window" else f"{label}/{n}"
        idle[f"idle in {label}" if label != "window" else "idle outside any call"] += (e - s) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": dict(kernels), "idle": dict(idle),
            "spans": {n: len(host[n]) for n in SPANS}}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten largest idle labels, in seconds."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:200], sec] for name, (_, sec) in ops],
            "idle_gaps": [[label, sec] for label, sec in idle]}
