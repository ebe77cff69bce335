"""staged_row_share: the share of the serving step's batch rows that the
program stepped straight from its staging buffer, 100 x the window's
``predict_granule`` roots' ``staged_rows`` counter over their ``rows``
counter (the program's ``tracing``, ``harness/program_spans.py``): on
CUDA rows uploaded from the pinned staging without a copy. It reads
nothing where no root counts ``staged_rows``: a program without the
counter."""

from benchmark.harness import program_spans


def read(rec):
    roots = program_spans.serving_roots(rec)
    staged = program_spans.counter_sum(roots, "staged_rows")
    rows = program_spans.counter_sum(roots, "rows")
    if staged is None or not rows:
        return None
    return 100.0 * staged / rows
