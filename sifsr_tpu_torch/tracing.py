"""Spans and counters inside the port, for operators and profilers.

The program's entry points open a root span (``predict_granule``,
``prepare_batch``, ``train_step``); their stages open child spans and add
to counters. A span records its name, its start and end on
``time.perf_counter_ns()``, its own id, its parent's id and its root's id,
so every span of one call shares the root's id. A finished root, with its
spans and counters, goes into an in-memory ring of the last ``CAPACITY``
roots: ``records()`` reads it, ``clear()`` empties it. Nothing is written
to disk.

Tracing is on while ``enable()`` is in force (until ``disable()``) and
whenever a ``torch.profiler`` is recording. While it is on, every root and
span also enters ``torch.profiler.record_function("sifsr." + name)``, so
the spans land on the profiler's timeline, on the clock of the device's
kernels and copies, nested as in the code. While it is off, ``span`` and
``root`` return one shared no-op context and ``count`` returns at once.

A span or a count with no open root on its thread is kept nowhere in
memory (a span still annotates the profiler). The open spans are
per-thread; the ring is shared by all threads.

    from sifsr_tpu_torch import tracing
    tracing.enable()
    predict_granule(...)
    for r in tracing.records():
        print(r["name"], r["end_ns"] - r["start_ns"], r["counts"],
              [(s["name"], s["end_ns"] - s["start_ns"]) for s in r["spans"]])
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque

import torch

__all__ = ["CAPACITY", "enable", "disable", "enabled", "root", "span", "count", "rooted",
           "records", "clear"]

CAPACITY = 16384
PREFIX = "sifsr."

_profiling = torch._C._autograd._profiler_enabled
_ring: deque = deque(maxlen=CAPACITY)
_ring_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_forced = False


def enable() -> None:
    """Trace every root and span from now until ``disable()``."""
    global _forced
    _forced = True


def disable() -> None:
    """Trace only while a ``torch.profiler`` records."""
    global _forced
    _forced = False


def enabled() -> bool:
    return _forced or _profiling()


class _Off:
    """The no-op context. Its methods are C callables, so that entering and
    leaving it runs no Python frame: ``NoneType()`` is None, and
    ``"".format`` takes the exception triple and returns "", which is false,
    so an exception propagates."""
    __slots__ = ()
    __enter__ = type(None)
    __exit__ = "".format


_OFF = _Off()


def _stack() -> list:
    """This thread's open spans, innermost last: (span record, its root record)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "is_root", "_annotation", "_record")

    def __init__(self, name: str, is_root: bool):
        self.name, self.is_root = name, is_root

    def __enter__(self):
        self._annotation = torch.profiler.record_function(PREFIX + self.name)
        self._annotation.__enter__()
        stack = _stack()
        outer, outer_root = stack[-1] if stack else (None, None)
        rec = None
        if self.is_root or outer_root is not None:
            rec = {"name": self.name, "id": next(_ids),
                   "parent": outer["id"] if outer is not None else None}
            if self.is_root:
                rec.update(root=rec["id"], spans=[], counts={})
                outer_root = rec
            else:
                rec["root"] = outer_root["id"]
                outer_root["spans"].append(rec)
            rec["start_ns"] = time.perf_counter_ns()
        self._record = rec
        stack.append((rec, outer_root))
        return None

    def __exit__(self, *exc):
        rec = self._record
        if rec is not None:
            rec["end_ns"] = time.perf_counter_ns()
        _stack().pop()
        if self.is_root:
            with _ring_lock:
                _ring.append(rec)
        self._annotation.__exit__(*exc)
        return False


def root(name: str):
    """A root span with a fresh id: one call of an entry point."""
    return _Span(name, True) if _forced or _profiling() else _OFF


def span(name: str):
    """A child of the innermost open span on this thread."""
    return _Span(name, False) if _forced or _profiling() else _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open root."""
    if not (_forced or _profiling()):
        return
    stack = _stack()
    if stack and stack[-1][1] is not None:
        counts = stack[-1][1]["counts"]
        counts[name] = counts.get(name, 0) + n


def rooted(name: str):
    """Decorate an entry point so that each call opens the root ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with root(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def records() -> list[dict]:
    """The ring's finished roots, oldest first (a copy of the ring)."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    with _ring_lock:
        _ring.clear()
