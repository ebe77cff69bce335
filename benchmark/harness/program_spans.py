"""The program's own spans and counters (``sifsr_tpu_torch.tracing``), as
the per-layer readers of a traced run take them.

The program traces while ``torch.profiler`` records, so a ``--trace 1``
window leaves its roots in the program's in-memory ring. The window's
roots of a name are the ring's last N of that name, N being the
benchmark's own count of its span around each call (``request`` for
``predict_granule``; ``prepare_batch`` and ``train_step`` for theirs).
Where the program keeps no such records (a version without tracing), or
holds fewer than N, or a serving root's ``blocks`` differ from the
request's, the readers read nothing: the two accounts must agree.
"""

from __future__ import annotations

# the program's root of each benchmark span around a call into it
ROOT_OF = {"request": "predict_granule", "prepare_batch": "prepare_batch",
           "train_step": "train_step"}


def _records():
    try:
        from sifsr_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def window_roots(rec, bench_span: str):
    """The program's roots of the window's calls under ``bench_span``, or
    None where they are not all held."""
    if not rec.trace or not rec.trace.get("spans"):
        return None
    n = rec.trace["spans"].get(bench_span, 0)
    held = _records()
    if not n or held is None:
        return None
    name = ROOT_OF[bench_span]
    roots = [r for r in held if r["name"] == name]
    return roots[-n:] if len(roots) >= n else None


def serving_roots(rec):
    """The window's ``predict_granule`` roots, where their ``blocks``
    are the requests' blocks, in order."""
    roots = window_roots(rec, "request")
    if roots is None or [r["counts"].get("blocks") for r in roots] != [
            q["blocks"] for q in rec.requests]:
        return None
    return roots


def span_ms(roots, name: str):
    """The mean over the roots of the summed duration of their spans
    ``name``, in ms; None where no root has such a span."""
    if not roots or not any(s["name"] == name for r in roots for s in r["spans"]):
        return None
    total = sum(s["end_ns"] - s["start_ns"] for r in roots for s in r["spans"]
                if s["name"] == name)
    return total / len(roots) * 1e-6


def root_ms(roots):
    """The mean duration of the roots, in ms."""
    if not roots:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in roots) / len(roots) * 1e-6


def counter_sum(roots, name: str):
    """The sum over the roots of the counter ``name``; None where no root has it."""
    if not roots or not any(name in r["counts"] for r in roots):
        return None
    return sum(r["counts"].get(name, 0) for r in roots)
