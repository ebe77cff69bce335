"""useful_row_share: the real blocks over the batch rows the serving step
ran, padding included, both counted by the program's ``predict_granule``
(its ``blocks`` and ``rows`` counters) over the window's requests."""

from benchmark.harness import program_spans


def read(rec):
    roots = program_spans.serving_roots(rec)
    blocks = program_spans.counter_sum(roots, "blocks")
    rows = program_spans.counter_sum(roots, "rows")
    if not blocks or not rows:
        return None
    return 100.0 * blocks / rows
