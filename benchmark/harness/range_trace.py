"""The traced window of ``trace.Tracer``, and besides its reduction the device
time of the kernels launched inside the program's own ranges (its
``sifsr.*`` spans on the profiler's timeline, forward and backward). A
kernel is attributed through the profiler's link from each device kernel to
the host op that launched it: the op's start lies inside a range of the
name on the op's own thread."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

from benchmark.harness.trace import Tracer, reduce_events


class RangeTracer(Tracer):
    """A ``Tracer`` whose summary also holds ``ranges``: {name: {"count":
    the ranges opened in the window, "device_s": the device seconds of the
    kernels launched inside them}} for each of ``names``."""

    def __init__(self, enabled: bool, names: tuple[str, ...]):
        super().__init__(enabled)
        self.names = names

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        try:
            with torch.profiler.record_function("window"):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            prof.__exit__(None, None, None)
        raw, ranges = [], []
        for e in prof.profiler.kineto_results.events():
            row = (e.name(), e.device_type() != torch.autograd.DeviceType.CPU,
                   e.is_user_annotation(), e.start_ns(), e.end_ns())
            raw.append(row)
            ranges.append((row, e.correlation_id(), e.linked_correlation_id(),
                           e.start_thread_id()))
        self.summary = reduce_events(raw)
        if self.summary:
            self.summary["ranges"] = reduce_ranges(ranges, self.names)


def reduce_ranges(events, names) -> dict:
    """{name: {"count", "device_s"}} from (row, correlation id, linked
    correlation id, thread) of every event, ``row`` as ``reduce_events``
    takes it; device time only inside the ``window`` range."""
    window = [(s, e) for (n, dev, ann, s, e), *_ in events if ann and not dev and n == "window"]
    w0, w1 = window[0] if window else (0, 0)
    opened = {n: defaultdict(list) for n in names}
    ops = {}
    device = defaultdict(float)
    for (name, dev, ann, s, e), corr, linked, tid in events:
        if ann and not dev:
            if name in opened and w0 <= s < w1:
                opened[name][tid].append((s, e))
        elif dev and not ann:
            if linked > 0:
                device[linked] += max(0, min(e, w1) - max(s, w0)) * 1e-9
        elif linked == 0:
            ops[corr] = (s, tid)
    out = {}
    for name, by_thread in opened.items():
        spans = {tid: sorted(v) for tid, v in by_thread.items()}
        starts = {tid: [s for s, _ in v] for tid, v in spans.items()}
        total = 0.0
        for corr, sec in device.items():
            s, tid = ops.get(corr, (None, None))
            if tid not in spans:
                continue
            i = bisect.bisect_right(starts[tid], s) - 1
            if i >= 0 and spans[tid][i][1] >= s:
                total += sec
        out[name] = {"count": sum(len(v) for v in spans.values()), "device_s": total}
    return out
