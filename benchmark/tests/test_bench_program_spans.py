"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and the metrics that use it) on synthetic
records, then on a traced run of each cell on the CPU."""

import types

import pytest

from benchmark import run
from benchmark.harness import core, program_spans
from conftest import tiny

MS = 1_000_000  # ns
SERVING = ("tile_ms", "batch_pad_ms", "upload_ms", "step_enqueue_ms", "device_wait_ms",
           "mosaic_ms", "fresh_host_mb", "useful_row_share")
TRAINING = ("train_wait_ms", "train_upload_ms", "train_enqueue_ms")
STAGE_MS = {"tile": 2.0, "pad": 40.0, "upload": 15.0, "step": 1.0, "wait": 9.0, "mosaic": 3.0}


def _root(name, t0, stages, counts):
    """A finished root starting at ``t0`` ms, its stages back to back."""
    spans, at = [], t0 * MS
    for i, (stage, ms) in enumerate(stages.items()):
        spans.append({"name": stage, "id": 1000 * t0 + i + 1, "parent": t0, "root": t0,
                      "start_ns": at, "end_ns": at + int(ms * MS)})
        at += int(ms * MS)
    return {"name": name, "id": t0, "parent": None, "root": t0, "start_ns": t0 * MS,
            "end_ns": at + MS, "spans": spans, "counts": counts}


def _requests(blocks):
    return [{"blocks": b, "seconds": 0.07, "step_s": 0.005} for b in blocks]


def _serving(monkeypatch, held, blocks, n=None):
    monkeypatch.setattr(program_spans, "_records", lambda: held)
    cell = core.load_cell("int8-aoi")
    n = len(blocks) if n is None else n
    rec = types.SimpleNamespace(cell=cell, requests=_requests(blocks),
                                trace={"spans": {"window": 1, "request": n, "sr_step": n}})
    return cell, rec


def _serving_root(t0, blocks, stages=STAGE_MS):
    return _root("predict_granule", t0, stages,
                 {"blocks": blocks, "rows": 324, "host_bytes": 180_000_000 + blocks})


def _read(cell, rec, names):
    return {m["name"]: run.reader(m["name"])(rec) for m in cell.per_layer() if m["name"] in names}


def test_serving_readers_take_the_window_tail(monkeypatch):
    """Earlier runs' roots (and other roots) stay in the ring before the
    window's: only the last N of the name are read."""
    earlier = [_serving_root(t, 9, {s: 99.0 for s in STAGE_MS}) for t in range(1, 4)]
    other = _root("prepare_batch", 50, {"upload": 1.0}, {})
    window = [_serving_root(100 + 200 * i, b) for i, b in enumerate((1, 4, 9))]
    cell, rec = _serving(monkeypatch, earlier + [other] + window, [1, 4, 9])
    got = _read(cell, rec, SERVING)
    assert set(got) == set(SERVING)
    for metric, stage in zip(SERVING, STAGE_MS):
        assert got[metric] == pytest.approx(STAGE_MS[stage]), metric
    assert got["fresh_host_mb"] == pytest.approx(180.0 + 14 / 3 / 1e6)
    assert got["useful_row_share"] == pytest.approx(100 * 14 / (3 * 324))


def test_nothing_read_with_fewer_roots_than_requests(monkeypatch):
    window = [_serving_root(100 + 200 * i, b) for i, b in enumerate((4, 9))]
    cell, rec = _serving(monkeypatch, window, [1, 4, 9])
    assert all(v is None for v in _read(cell, rec, SERVING).values())


def test_nothing_read_where_the_blocks_differ(monkeypatch):
    window = [_serving_root(100 + 200 * i, b) for i, b in enumerate((1, 9, 4))]
    cell, rec = _serving(monkeypatch, window, [1, 4, 9])
    assert all(v is None for v in _read(cell, rec, SERVING).values())


def test_nothing_read_from_a_program_without_tracing(monkeypatch):
    """A program without ``tracing`` (an older version) keeps no records."""
    cell, rec = _serving(monkeypatch, None, [1, 4, 9])
    assert all(v is None for v in _read(cell, rec, SERVING).values())
    rec.trace = None
    assert all(v is None for v in _read(cell, rec, SERVING).values())


def test_a_stage_no_root_has_is_not_read(monkeypatch):
    stages = {k: v for k, v in STAGE_MS.items() if k != "pad"}
    window = [_serving_root(100 + 200 * i, b, stages) for i, b in enumerate((1, 4, 9))]
    cell, rec = _serving(monkeypatch, window, [1, 4, 9])
    got = _read(cell, rec, SERVING)
    assert got["batch_pad_ms"] is None and got["tile_ms"] == pytest.approx(2.0)


@pytest.mark.parametrize("blocks,rows", [((1, 4, 9), 324), ((324, 324), 324), ((2, 2), 4)])
def test_useful_row_share_within_0_to_100(monkeypatch, blocks, rows):
    window = [_root("predict_granule", 100 + 200 * i, STAGE_MS,
                    {"blocks": b, "rows": max(rows, b), "host_bytes": 1})
              for i, b in enumerate(blocks)]
    cell, rec = _serving(monkeypatch, window, list(blocks))
    share = run.reader("useful_row_share")(rec)
    assert 0.0 < share <= 100.0
    assert share == pytest.approx(100 * sum(blocks) / sum(max(rows, b) for b in blocks))


def test_training_readers(monkeypatch):
    held = [_root("train_step", 1, {}, {})]     # an earlier run's
    for i in range(4):
        t = 100 + 100 * i
        held.append(_root("prepare_batch", t, {"wait": 45.0, "upload": 2.0}, {}))
        held.append(_root("train_step", t + 50, {}, {}))
    monkeypatch.setattr(program_spans, "_records", lambda: held)
    cell = core.load_cell("f32-train")
    rec = types.SimpleNamespace(cell=cell, trace={"spans": {"window": 1, "prepare_batch": 4,
                                                            "train_step": 4}})
    got = _read(cell, rec, TRAINING)
    assert got == pytest.approx({"train_wait_ms": 45.0, "train_upload_ms": 2.0,
                                 "train_enqueue_ms": 1.0})
    rec.trace["spans"]["train_step"] = 6
    assert run.reader("train_enqueue_ms")(rec) is None


def test_the_program_ring_feeds_the_readers(monkeypatch):
    """The readers on the program's own ring, filled through its API."""
    from sifsr_tpu_torch import tracing

    tracing.enable()
    try:
        tracing.clear()
        for b in (1, 4):
            with tracing.root("predict_granule"):
                tracing.count("blocks", b)
                tracing.count("rows", 8)
                with tracing.span("pad"):
                    tracing.count("host_bytes", 2_000_000)
        cell = core.load_cell("int8-aoi")
        rec = types.SimpleNamespace(cell=cell, requests=_requests([1, 4]),
                                    trace={"spans": {"request": 2}})
        assert run.reader("useful_row_share")(rec) == pytest.approx(100 * 5 / 16)
        assert run.reader("fresh_host_mb")(rec) == pytest.approx(2.0)
        assert run.reader("batch_pad_ms")(rec) > 0
        assert run.reader("tile_ms")(rec) is None
    finally:
        tracing.disable()
        tracing.clear()


@pytest.mark.parametrize("name,want", [("int8-aoi", SERVING), ("f32-granule", SERVING),
                                       ("f32-train", ("train_upload_ms", "train_enqueue_ms"))])
def test_a_traced_cpu_run_reads_the_program_metrics(name, want):
    """The program traces under the traced window's profiler: its metrics
    read on the CPU wherever the CPU has the stage (no stream to wait on
    before a CPU batch's upload)."""
    cell = core.load_cell(name)
    line, _ = run.execute(cell, 3_000_000_037, 0.5, True, "cpu", overrides=tiny(cell))
    got = line["metrics"]
    assert set(want) <= set(got), set(want) - set(got)
    for metric in want:
        assert got[metric]["value"] > 0, metric
    if "useful_row_share" in want:
        assert got["useful_row_share"]["value"] <= 100.0
    if name == "int8-aoi":
        assert got["useful_row_share"]["value"] == pytest.approx(
            got["useful_block_share.aoi"]["value"], abs=0.01)
