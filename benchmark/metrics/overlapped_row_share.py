"""overlapped_row_share: the share of the serving step's batch rows that
the program submitted while an earlier batch of the same call was still
pending in its pipeline, 100 x the window's ``predict_granule`` roots'
``overlapped_rows`` counter over their ``rows`` counter (the program's
``tracing``, ``harness/program_spans.py``): rows whose step could run
beside the host's copies of another batch. It reads nothing where no root
counts ``overlapped_rows``: calls of one batch each, or a program without
the counter."""

from benchmark.harness import program_spans


def read(rec):
    roots = program_spans.serving_roots(rec)
    overlapped = program_spans.counter_sum(roots, "overlapped_rows")
    rows = program_spans.counter_sum(roots, "rows")
    if overlapped is None or not rows:
        return None
    return 100.0 * overlapped / rows
