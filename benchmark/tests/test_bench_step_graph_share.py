"""``step_graph_share`` on synthetic ``predict_granule`` roots: 100 x the
window's roots' ``graph_replays`` over their ``step`` spans."""

import pytest

from benchmark import run
from test_bench_program_spans import _serving, _serving_root


@pytest.mark.parametrize("replays,want", [((1, 1, 1), 100.0), ((0, 1, 1), 200 / 3),
                                          ((None, None, None), None)])
def test_step_graph_share_reads_replays_over_step_spans(monkeypatch, replays, want):
    """A root without the counter (an eager call) counts none, and nothing
    is read where no root counts it (a step without graphs, or an older
    program)."""
    window = []
    for i, (b, r) in enumerate(zip((1, 4, 9), replays)):
        counts = {"blocks": b, "rows": b, "host_bytes": 1}
        if r:
            counts["graph_replays"] = r
        window.append(_serving_root(100 + 200 * i, b) | {"counts": counts})
    cell, rec = _serving(monkeypatch, window, [1, 4, 9])
    got = run.reader("step_graph_share")(rec)
    assert got == (None if want is None else pytest.approx(want))
    rec.trace = None
    assert run.reader("step_graph_share")(rec) is None
