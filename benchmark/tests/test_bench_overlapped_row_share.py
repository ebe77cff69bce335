"""``overlapped_row_share`` on synthetic ``predict_granule`` roots and on
the program's own ring: 100 x the window's roots' ``overlapped_rows`` over
their ``rows``."""

import types

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import core
from test_bench_program_spans import _serving, _serving_root


@pytest.mark.parametrize("overlapped,want", [((243, 243, 243), 75.0),
                                             ((None, 243, 243), 100 * 486 / 972),
                                             ((None, None, None), None)])
def test_overlapped_row_share_reads_overlapped_rows_over_rows(monkeypatch, overlapped, want):
    """A root without the counter (a one-batch call) counts none, and
    nothing is read where no root counts it (calls of one batch each, or an
    older program)."""
    window = []
    for i, o in enumerate(overlapped):
        counts = {"blocks": 324, "rows": 324, "host_bytes": 1}
        if o:
            counts["overlapped_rows"] = o
        window.append(_serving_root(100 + 200 * i, 324) | {"counts": counts})
    cell, rec = _serving(monkeypatch, window, [324, 324, 324])
    got = run.reader("overlapped_row_share")(rec)
    assert got == (None if want is None else pytest.approx(want))
    rec.trace = None
    assert run.reader("overlapped_row_share")(rec) is None


def test_overlapped_row_share_reads_the_program_counter():
    """On the program's ring: a 324-block granule at window 8 goes as four
    batches of 81, three of them submitted while the first is pending; a
    9-block area is one batch and counts nothing."""
    from sifsr_tpu_torch import inference, tracing
    from sifsr_tpu_torch.data.statistics import Statistics

    stats = Statistics.from_json(str(core.ROOT / "data" / "statistics_testset.json"))
    rng = np.random.default_rng(5)

    def stub(params, lst, ndvi):
        return ndvi + lst.mean(dim=(1, 2))[:, None, None]

    def reading(blocks):
        rec = types.SimpleNamespace(requests=[{"blocks": b} for b in blocks],
                                    trace={"spans": {"request": len(blocks)}})
        return run.reader("overlapped_row_share")(rec)

    tracing.enable()
    try:
        tracing.clear()
        for side in (144, 24):
            lst = (296.0 + 20.0 * rng.random((side, side))).astype(np.float32)
            ndvi = rng.random((4 * side, 4 * side)).astype(np.float32)
            inference.predict_granule({}, lst, ndvi, stats, batch_size=324, window=8, factor=4,
                                      sr_step=stub, device="cpu")
        assert reading([324, 9]) == pytest.approx(100 * 243 / 333)
        assert reading([9]) is None
    finally:
        tracing.disable()
        tracing.clear()
