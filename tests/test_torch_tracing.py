"""The port's tracing (``sifsr_tpu_torch.tracing``) on the CPU: off by
default and without effect on the mosaic; the roots, stage spans and
counters of ``predict_granule`` in each of its paths, ``prepare_batch`` and
``train_step``; the profiler's annotations; the ring's capacity; spans and
counts with no open root.

The granule is 32x48 LST at window 16 (2x3 = 6 blocks) with a 128x192
NDVI, served at batch 8, so its one batch is its last: stepped at its own 6
rows, with no padding."""

import os
import threading

import numpy as np
import pytest
import torch

from sifsr_tpu_torch import inference, tracing
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.datasets import prepare_batch
from sifsr_tpu_torch.data.statistics import Statistics
from sifsr_tpu_torch.models.unet import ModelB2
from sifsr_tpu_torch.train.state import create_train_state
from sifsr_tpu_torch.train.step import make_train_step

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WEIGHTS = os.path.join(ROOT, "weights", "modelB_1009")
STATS_JSON = os.path.join(ROOT, "data", "statistics_testset.json")
WINDOW, FACTOR, BATCH = 16, 4, 8
STAGES = {"tile", "pad", "upload", "step", "wait", "mosaic"}
F32 = 4


@pytest.fixture(autouse=True)
def fresh_tracing():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def stats():
    return Statistics.from_json(STATS_JSON)


@pytest.fixture(scope="module")
def variables():
    return load_variables(WEIGHTS)


@pytest.fixture(scope="module")
def granule():
    rng = np.random.default_rng(11)
    lst = (296.0 + 20.0 * rng.random((32, 48))).astype(np.float32)
    ndvi = (-0.2 + 1.4 * rng.random((128, 192))).astype(np.float32)   # some clipped
    return lst, ndvi


def _stub_step(params, lst, ndvi):
    """A serving step without a model: the LST block's mean over the NDVI."""
    return ndvi + lst.mean(dim=(1, 2))[:, None, None]


def _predict(granule, stats, variables=None, **kw):
    kw.setdefault("sr_step", _stub_step if variables is None else None)
    return inference.predict_granule(variables or {}, *granule, stats, batch_size=BATCH,
                                     window=WINDOW, factor=FACTOR, compute_dtype=torch.float32,
                                     device="cpu", **kw)


def _roots(name="predict_granule"):
    return [r for r in tracing.records() if r["name"] == name]


def _check_tree(root):
    """Every span is the root's, nests within its parent, and ends after it starts."""
    by_id = {root["id"]: root, **{s["id"]: s for s in root["spans"]}}
    assert root["root"] == root["id"] and root["start_ns"] <= root["end_ns"]
    for s in root["spans"]:
        assert s["root"] == root["id"]
        parent = by_id[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]


def test_off_records_nothing_and_the_mosaic_is_bitwise_equal(granule, stats, variables):
    assert not tracing.enabled()
    off = _predict(granule, stats, variables)
    assert tracing.records() == []
    tracing.enable()
    on = _predict(granule, stats, variables)
    assert len(_roots()) == 1
    assert on.dtype == off.dtype and on.shape == (128, 192)
    np.testing.assert_array_equal(on, off)
    assert np.all(on > 250.0)


def test_host_pipeline_root_stages_and_counts(granule, stats):
    tracing.enable()
    _predict(granule, stats)
    (root,) = _roots()
    _check_tree(root)
    assert {s["name"] for s in root["spans"]} == STAGES
    assert all(s["parent"] == root["id"] for s in root["spans"])
    n, fwin = 6, WINDOW * FACTOR
    lst_block, ndvi_block = WINDOW * WINDOW * F32, fwin * fwin * F32
    # the NDVI clip and the cast go straight into the staging, each batch is
    # a view of it, and each download goes straight into the mosaic
    want = (n * (lst_block + ndvi_block)           # the staging (plain on the CPU)
            + n * WINDOW * WINDOW                  # the coverage test's mask (bool)
            + n * ndvi_block)                      # the mosaic
    assert root["counts"] == {"blocks": n, "rows": n, "staged_rows": n, "host_bytes": want}


def _recording(step, seen):
    """``step`` that appends the rows of each batch it is given to ``seen``."""
    def rec(params, lst, ndvi):
        seen.append((lst.shape[0], ndvi.shape[0]))
        return step(params, lst, ndvi)
    return rec


@pytest.mark.parametrize("overlap", [0, 4])
@pytest.mark.parametrize("kind", ["stub", "float32"])
def test_the_last_batch_is_stepped_at_its_own_rows(granule, stats, variables, kind, overlap):
    """6 blocks (12 origins at overlap 4) at batch 4 (8) leave a last batch of
    2 (4) blocks: every step call sees exactly its real rows, the ``rows``
    counter counts them, and the mosaic is bit-equal to the same granule at
    a batch that divides the block count."""
    from sifsr_tpu_torch.models.fused import InferenceModelB2

    if kind == "stub":
        step, params = _stub_step, None
    else:
        step = inference.make_sr_step(stats, torch.float32, "cpu")
        params = InferenceModelB2.from_variables(variables).to("cpu", torch.float32)
    n, batch = (6, 4) if overlap == 0 else (12, 8)
    tracing.enable()
    got = {}
    for bs in (batch, n):
        seen = []
        tracing.clear()
        out = inference.predict_granule({}, *granule, stats, batch_size=bs, window=WINDOW,
                                        factor=FACTOR, overlap=overlap,
                                        sr_step=_recording(step, seen), step_params=params,
                                        device="cpu")
        (root,) = _roots()
        assert root["counts"]["blocks"] == root["counts"]["rows"] == n
        got[bs] = out, seen
    assert got[batch][1] == [(batch, batch), (n - batch, n - batch)]
    assert got[n][1] == [(n, n)]
    assert got[n][0].shape == (128, 192) and np.all(got[n][0] > 0.0)
    np.testing.assert_array_equal(got[batch][0], got[n][0])


def test_stage_spans_cover_the_root(granule, stats, variables):
    """The six stages hold nearly all of a call with the step given."""
    from sifsr_tpu_torch.models.fused import InferenceModelB2

    step = inference.make_sr_step(stats, torch.float32, "cpu")
    params = InferenceModelB2.from_variables(variables).to("cpu", torch.float32)
    tracing.enable()
    _predict(granule, stats, sr_step=step, step_params=params)
    (root,) = _roots()
    inside = sum(s["end_ns"] - s["start_ns"] for s in root["spans"])
    assert inside >= 0.9 * (root["end_ns"] - root["start_ns"])


def test_the_int8_step_stays_eager_on_the_cpu(granule, stats, variables):
    """On the CPU the int8 step is its eager step: no CUDA graph is captured
    or replayed, so the root counts ``graph_replays`` and ``graph_captures``
    as 0 (neither is counted)."""
    from sifsr_tpu_torch.models import int8_serving

    lst_b, ndvi_b, _ = inference.tile_granule(*granule, WINDOW, FACTOR)
    params = int8_serving.build_int8_serving_params(variables, lst_b[:2],
                                                    np.clip(ndvi_b[:2], -1.0, 1.0), stats,
                                                    device="cpu")
    step = int8_serving.make_int8_sr_step(stats, device="cpu")
    assert step.eager is step
    tracing.enable()
    out = _predict(granule, stats, sr_step=step, step_params=params)
    (root,) = _roots()
    _check_tree(root)
    assert {s["name"] for s in root["spans"]} == STAGES
    counts = root["counts"]
    assert counts.get("graph_replays", 0) == counts.get("graph_captures", 0) == 0
    assert counts["blocks"] == counts["rows"] == 6
    assert out.shape == (128, 192) and np.all(np.isfinite(out))


def test_overlap_path_opens_the_root_and_its_stages(granule, stats):
    tracing.enable()
    _predict(granule, stats, overlap=4)
    (root,) = _roots()
    _check_tree(root)
    assert {s["name"] for s in root["spans"]} == STAGES
    # origins at stride 12 over 32x48: rows 0, 12, 16; columns 0, 12, 24, 32;
    # batches of 8 and 4, neither padded
    assert root["counts"]["blocks"] == 12 and root["counts"]["rows"] == 12
    assert root["counts"]["host_bytes"] > 2 * 128 * 192 * 8        # the two float64 sums


@pytest.mark.parametrize("wire", [None, "int"])
def test_device_tiling_opens_the_root_and_its_stages(granule, stats, wire):
    tracing.enable()
    _predict(granule, stats, device_tiling=True, wire=wire)
    (root,) = _roots()
    _check_tree(root)
    # on the CPU nothing is waited for: the mosaic is the step's own memory
    assert {s["name"] for s in root["spans"]} == STAGES - {"pad", "wait"}
    assert root["counts"]["blocks"] == 6 and root["counts"]["rows"] == 6
    clip = 128 * 192 * F32
    if wire is None:
        assert root["counts"]["host_bytes"] == clip
    else:        # encode: three float temporaries and the code, each input; decode: one
        codes = (32 * 48 + 128 * 192) * 2
        want = clip + 3 * 2 * codes + codes + 128 * 192 * F32
        assert root["counts"]["host_bytes"] == want


def test_wire_host_pipeline_counts_encode_and_decode(granule, stats):
    tracing.enable()
    _predict(granule, stats, wire="int")
    (root,) = _roots()
    n, fwin = 6, WINDOW * FACTOR
    codes = (32 * 48 + 128 * 192) * 2                # uint16 LST and int16 NDVI
    block = (WINDOW * WINDOW + fwin * fwin) * 2      # one block pair on the wire
    want = (128 * 192 * F32                          # the NDVI clip
            + 3 * 2 * codes + codes                  # encode: three float temporaries, the codes
            + n * block                              # the staged codes (plain on the CPU)
            + n * WINDOW * WINDOW                    # the coverage test's mask
            + n * fwin * fwin * F32)                 # the mosaic, decoded into in place
    assert root["counts"] == {"blocks": n, "rows": n, "staged_rows": n, "host_bytes": want}


def _grid(gh, gw, window=8, seed=3):
    """A gh x gw grid of blocks at ``window`` and its NDVI, partly past [-1, 1]."""
    rng = np.random.default_rng(seed)
    lst = (296.0 + 20.0 * rng.random((gh * window, gw * window))).astype(np.float32)
    ndvi = (-0.2 + 1.4 * rng.random((FACTOR * gh * window, FACTOR * gw * window)))
    return lst, ndvi.astype(np.float32)


@pytest.mark.parametrize("wire", [None, "int"])
@pytest.mark.parametrize("overlap", [0, 2])
def test_a_large_call_counts_what_one_batch_counts(stats, monkeypatch, overlap, wire):
    """324 blocks (256 origins at overlap 2 over 12 x 12 blocks) go as four
    batches, each filled under a ``tile`` span of its own: the root counts
    the blocks, rows, staged rows and host bytes of the same call stepped
    as one batch, and the rows of the three batches submitted while the
    first was pending as ``overlapped_rows``; the mosaic is the one batch's."""
    gh = 18 if overlap == 0 else 12
    lst, ndvi = _grid(gh, gh)
    tracing.enable()
    got = {}
    for parts in (4, 1):                 # one part: the whole call in one batch
        monkeypatch.setattr(inference, "_SPLIT_INTO", parts)
        seen = []
        tracing.clear()
        out = inference.predict_granule({}, lst, ndvi, stats, batch_size=324, window=8,
                                        factor=FACTOR, overlap=overlap, wire=wire,
                                        sr_step=_recording(_stub_step, seen), device="cpu")
        (root,) = _roots()
        _check_tree(root)
        assert all(s["parent"] == root["id"] for s in root["spans"])
        assert {s["name"] for s in root["spans"]} == STAGES
        names = [s["name"] for s in root["spans"]]
        # ``tile``: the inputs' clip and encoding, the staging, then one a batch
        assert names.count("step") == len(seen) and names.count("tile") == 2 + len(seen)
        got[parts] = out, [r for r, _ in seen], dict(root["counts"])
    (chunked, rows, counts), (one, one_rows, one_counts) = got[4], got[1]
    n = 324 if overlap == 0 else 256
    assert rows == [n // 4] * 4 and one_rows == [n]
    assert counts.pop("overlapped_rows") == n - rows[0]
    assert "overlapped_rows" not in one_counts
    assert counts == one_counts and counts["blocks"] == counts["rows"] == n
    np.testing.assert_array_equal(chunked, one)


@pytest.mark.parametrize("gh,gw,batch,want", [(3, 3, 324, [9]), (11, 11, 324, [121]),
                                              (1, 127, 324, [127]), (11, 11, 50, [50, 50, 21]),
                                              (8, 16, 324, [64, 64])])
def test_the_step_calls_by_block_count(stats, gh, gw, batch, want):
    """Under 128 blocks the batches are ``batch_size`` rows, the last at its
    own: a 9-block area is one step call and counts no ``overlapped_rows``.
    From 128 blocks the call splits, here into two batches of 64."""
    seen = []
    tracing.enable()
    inference.predict_granule({}, *_grid(gh, gw), stats, batch_size=batch, window=8,
                              factor=FACTOR, sr_step=_recording(_stub_step, seen), device="cpu")
    (root,) = _roots()
    assert [r for r, _ in seen] == want
    if len(want) == 1:
        assert "overlapped_rows" not in root["counts"]
    else:
        assert root["counts"]["overlapped_rows"] == sum(want) - want[0]


def test_profiler_annotations_without_enable(granule, stats):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tracing.enabled()
        _predict(granule, stats)
    assert not tracing.enabled()
    events = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    roots = [e for e in events if e.name == "sifsr.predict_granule"]
    assert len(roots) == 1
    r = roots[0].time_range
    stages = [e for e in events if e is not roots[0]]
    assert {e.name for e in stages} == {tracing.PREFIX + s for s in STAGES}
    for e in stages:
        assert r.start <= e.time_range.start <= e.time_range.end <= r.end
    (root,) = _roots()                               # and the records are kept
    assert len(root["spans"]) == len(stages)


def test_prepare_batch_and_train_step_roots():
    model = ModelB2(downchannels=(4, 8, 16, 32))
    state = create_train_state(model, 1e-3, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(model, "predef_filters", 0.99, -0.5, 300.0, 8.0)
    rng = np.random.default_rng(0)
    batch = {"lst": rng.normal(size=(2, 8, 8, 1)).astype(np.float32),
             "ndvi": rng.normal(size=(2, 32, 32, 1)).astype(np.float32)}
    tracing.enable()
    for _ in range(2):
        _, metrics = step(state, prepare_batch(batch, "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    names = [r["name"] for r in tracing.records()]
    assert names == ["prepare_batch", "train_step"] * 2
    for r in _roots("prepare_batch"):
        _check_tree(r)
        assert [s["name"] for s in r["spans"]] == ["upload"]    # no stream to wait on
    for r in _roots("train_step"):
        assert r["spans"] == [] and r["end_ns"] > r["start_ns"]


def test_the_ring_drops_its_oldest_roots():
    tracing.enable()
    for i in range(tracing.CAPACITY + 3):
        with tracing.root("r"):
            tracing.count("i", i)
    got = tracing.records()
    assert len(got) == tracing.CAPACITY
    assert got[0]["counts"] == {"i": 3} and got[-1]["counts"] == {"i": tracing.CAPACITY + 2}
    got.clear()                                       # a copy: the ring is unchanged
    assert len(tracing.records()) == tracing.CAPACITY


def test_a_span_or_count_with_no_open_root_keeps_nothing():
    tracing.enable()
    with tracing.span("alone"):
        with tracing.span("inner"):
            tracing.count("n", 1)
    tracing.count("n", 1)
    assert tracing.records() == []
    with tracing.root("r"):
        pass
    (r,) = tracing.records()
    assert r["spans"] == [] and r["counts"] == {}


def test_nested_roots_and_counts_go_to_the_innermost_root():
    tracing.enable()
    with tracing.root("outer"):
        tracing.count("n", 1)
        with tracing.span("s"):
            with tracing.root("inner"):
                tracing.count("n", 10)
                with tracing.span("t"):
                    pass
        tracing.count("n", 2)
    inner, outer = tracing.records()              # a root enters the ring as it ends
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert outer["counts"] == {"n": 3} and inner["counts"] == {"n": 10}
    (s,) = outer["spans"]
    assert inner["parent"] == s["id"] and inner["root"] == inner["id"] != outer["id"]
    assert [t["root"] for t in inner["spans"]] == [inner["id"]]


def test_off_is_one_shared_no_op():
    assert tracing.span("a") is tracing.root("b") is tracing.span("c")
    with tracing.span("a") as entered:
        tracing.count("n", 1)
    assert entered is None
    with pytest.raises(KeyError):                     # an exception passes through
        with tracing.root("b"):
            raise KeyError("b")
    tracing.enable()
    assert tracing.span("a") is not tracing.span("a")
    tracing.disable()
    assert tracing.records() == []


def test_threads_keep_their_own_open_spans():
    tracing.enable()
    ready, go = threading.Barrier(2), threading.Event()

    def work(name):
        with tracing.root(name):
            ready.wait(timeout=10)
            with tracing.span(name + ".stage"):
                go.wait(timeout=10)
            tracing.count(name, 1)

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    roots = {r["name"]: r for r in tracing.records()}
    for name in ("a", "b"):
        r = roots[name]
        _check_tree(r)
        assert [s["name"] for s in r["spans"]] == [name + ".stage"]
        assert r["counts"] == {name: 1}


def _hat_step_roots(n=2, lr=16, with_profiler=False):
    """Two traced HAT ``predef_filters`` steps at a small size (2 groups of
    2 HABs, windows of 4 on a 16² LR grid, key windows of 6²): the
    ``train_step`` roots, and the profiler's events when one recorded."""
    from sifsr_tpu_torch.models.hat import HAT

    model = HAT(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=4,
                squeeze_factor=6, num_feat=8)
    state = create_train_state(model, 2e-4, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(model, "predef_filters", 0.99, -0.5, 300.0, 8.0)
    rng = np.random.default_rng(0)
    batch = {"lst": rng.normal(size=(n, lr, lr, 1)).astype(np.float32),
             "ndvi": rng.normal(size=(n, 4 * lr, 4 * lr, 1)).astype(np.float32)}
    if with_profiler:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(state, prepare_batch(batch, "cpu"))
        return _roots("train_step"), prof.events()
    tracing.enable()
    for _ in range(2):
        step(state, prepare_batch(batch, "cpu"))
    return _roots("train_step"), None


def test_hat_step_opens_its_spans_and_counts_its_work():
    """Each HAT step: one ``swin.attention`` span per HAB forward and one
    backward, as many ``hat.cab`` spans, one ``hat.ocab_attention`` per
    group each way; the counters read the windows of every HAB
    (``swin_windows``) and OCAB (``ocab_windows``), the samples of every CAB
    (``cab_blocks``) and the LR tokens."""
    roots, _ = _hat_step_roots()
    assert len(roots) == 2
    habs, groups, n, windows = 4, 2, 2, (16 // 4) ** 2
    for r in roots:
        _check_tree(r)
        names = [s["name"] for s in r["spans"]]
        assert names.count("swin.attention") == 2 * habs
        assert names.count("hat.cab") == 2 * habs
        assert names.count("hat.ocab_attention") == 2 * groups
        assert len(names) == 4 * habs + 2 * groups
        assert r["counts"] == {"tokens": n * 16 * 16, "swin_windows": n * windows * habs,
                               "ocab_windows": n * windows * groups, "cab_blocks": n * habs}


def test_hat_ocab_ranges_lie_outside_the_window_attention_ranges():
    """On the profiler's timeline no ``sifsr.hat.ocab_attention`` range lies
    inside a ``sifsr.swin.attention`` range, nor a ``sifsr.hat.cab`` range
    inside either: no kernel is counted by two of the attention metrics."""
    _, events = _hat_step_roots(with_profiler=True)

    def ranges(name):
        return [(e.time_range.start, e.time_range.end) for e in events if e.name == name]

    swin, ocab, cab = (ranges(f"sifsr.{n}")
                       for n in ("swin.attention", "hat.ocab_attention", "hat.cab"))
    assert (len(swin), len(ocab), len(cab)) == (8, 4, 8)
    for inner in ocab + cab:
        for outer in swin + (ocab if inner in cab else []):
            assert not (outer[0] <= inner[0] and inner[1] <= outer[1]), (inner, outer)
