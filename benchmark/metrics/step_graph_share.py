"""step_graph_share: the share of the window's serving-step calls that the
program served by replaying a CUDA graph, 100 x the window's
``predict_granule`` roots' ``graph_replays`` counter over their ``step``
spans (the program's ``tracing``, ``harness/program_spans.py``). It reads
nothing where no root counts ``graph_replays``: a step that replays no
graph, or a program without the counter."""

from benchmark.harness import program_spans


def read(rec):
    roots = program_spans.serving_roots(rec)
    replays = program_spans.counter_sum(roots, "graph_replays")
    steps = sum(s["name"] == "step" for r in roots or () for s in r["spans"])
    if replays is None or not steps:
        return None
    return 100.0 * replays / steps
