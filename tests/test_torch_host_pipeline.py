"""``predict_granule``'s host pipeline on the CPU against the plain
composition it replaces: ``np.clip`` of the NDVI, ``tile_granule``, the
same step over the same batches, the coverage mask and ``untile_mosaic``.

The pipeline writes each block's inputs once, straight into the staging
its batches are stepped from, and each batch's output once, straight into
the mosaic it returns. Its mosaics must be the composition's bit for bit:
batches that split the grid's rows, strided area views, float64 inputs,
the NDVI unclipped, blocks zeroed by the coverage test, the integer wire
and the float32 model step. The granule is 32x48 LST at window 16 (a 2x3
grid of blocks) with a 128x192 NDVI, or 64x48 (4x3)."""

import os
import types

import numpy as np
import pytest
import torch

from benchmark.harness import core
from sifsr_tpu_torch import inference, tracing
from sifsr_tpu_torch.cli.predict import load_variables
from sifsr_tpu_torch.data.statistics import Statistics

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
WINDOW, FACTOR, BLOCKS = 16, 4, 6
FWIN = WINDOW * FACTOR


@pytest.fixture(autouse=True)
def fresh_tracing():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def stats():
    return Statistics.from_json(os.path.join(ROOT, "data", "statistics_testset.json"))


@pytest.fixture(scope="module")
def f32_step(stats):
    from sifsr_tpu_torch.models.fused import InferenceModelB2

    variables = load_variables(os.path.join(ROOT, "weights", "modelB_1009"))
    return (inference.make_sr_step(stats, torch.float32, "cpu"),
            InferenceModelB2.from_variables(variables).to("cpu", torch.float32))


def _stub_step(params, lst, ndvi):
    """A serving step without a model: the LST block's mean over the NDVI."""
    return ndvi + lst.mean(dim=(1, 2))[:, None, None]


def _granule(seed=11, rows=32):
    rng = np.random.default_rng(seed)
    lst = (296.0 + 20.0 * rng.random((rows, 48))).astype(np.float32)
    ndvi = (-0.2 + 1.4 * rng.random((4 * rows, 192))).astype(np.float32)   # some clipped
    return lst, ndvi


def _tall(seed=11):
    """A 4x3 grid: at batch 5 the second batch is the end of a grid row,
    a whole row and the start of the next."""
    return _granule(seed, rows=64)


def _strided(seed=11):
    """Area views into a larger pool granule, as ``int8-aoi`` sends them,
    with a partial edge block on each axis that the tiling drops."""
    rng = np.random.default_rng(seed)
    lst = (296.0 + 20.0 * rng.random((60, 80))).astype(np.float32)
    ndvi = (-0.2 + 1.4 * rng.random((240, 320))).astype(np.float32)
    return lst[5:39, 7:57], ndvi[20:156, 28:228]


def _float64(seed=11):
    """Float64 inputs whose float32 casts round."""
    lst, ndvi = _granule(seed)
    rng = np.random.default_rng(seed + 1)
    return (lst.astype(np.float64) + 1e-5 * rng.random(lst.shape),
            ndvi.astype(np.float64) + 1e-9 * rng.random(ndvi.shape))


def _cloudy(seed=11):
    """Block (0, 1) all 0 K, block (1, 2) half, block (1, 0) a quarter."""
    lst, ndvi = _granule(seed)
    lst = lst.copy()
    lst[0:16, 16:32] = 0.0
    lst[16:24, 32:48] = 0.0
    lst[16:20, 0:16] = 0.0
    return lst, ndvi


CASES = {
    "batch1": dict(batch_size=1),
    "batch4": dict(batch_size=4),
    "batch5": dict(batch_size=5),
    "whole_grid": dict(batch_size=6),
    "tall_grid": dict(batch_size=5, inputs=_tall),
    "strided_views": dict(batch_size=4, inputs=_strided),
    "float64": dict(batch_size=5, inputs=_float64),
    "ndvi_unclipped": dict(batch_size=4, ndvi_clip=False),
    "coverage": dict(batch_size=4, coverage=0.4, inputs=_cloudy),
    "wire_int": dict(batch_size=4, wire="int"),
    "float32_step": dict(batch_size=4, step="float32"),
}


def _plain(lst, ndvi, step, params, batch_size, coverage=1.0, ndvi_clip=True, wire=None,
           window=WINDOW):
    """The composition: clip, tile, the step over the same batches, mask,
    untile."""
    if ndvi_clip:
        ndvi = np.clip(ndvi, -1.0, 1.0)
    if wire == "int":
        lst_w, ndvi_w = inference.encode_wire(lst, ndvi)
        lst_b, ndvi_b, grid = inference.tile_granule(lst_w.view(np.int16), ndvi_w, window,
                                                     FACTOR)
        step = inference._wire_step(step, torch.device("cpu"))
    else:
        lst_b, ndvi_b, grid = inference.tile_granule(np.asarray(lst, np.float32),
                                                     np.asarray(ndvi, np.float32), window,
                                                     FACTOR)
    lst_t = torch.from_numpy(np.ascontiguousarray(lst_b))
    ndvi_t = torch.from_numpy(np.ascontiguousarray(ndvi_b))
    out = torch.cat([step(params, lst_t[i:i + batch_size], ndvi_t[i:i + batch_size])
                     for i in range(0, len(lst_b), batch_size)]).numpy()
    if wire == "int":
        out = out.view(np.uint16).astype(np.float32) * inference.WIRE_LST_STEP
    keep = (lst_b == 0).mean(axis=(1, 2)) <= coverage
    out[~keep] = 0.0
    return inference.untile_mosaic(out, grid)


@pytest.mark.parametrize("case", list(CASES))
def test_predict_granule_equals_the_plain_composition(stats, f32_step, case):
    """Bit-equal to the composition, every row stepped straight from the
    staging; a second call on other inputs returns a new array and leaves
    the first call's mosaic as it was."""
    opts = dict(CASES[case])
    inputs = opts.pop("inputs", _granule)
    step, params = f32_step if opts.pop("step", None) == "float32" else (_stub_step, None)
    plain_opts = {k: opts[k] for k in ("batch_size", "coverage", "ndvi_clip", "wire") if k in opts}

    def predict(lst, ndvi):
        return inference.predict_granule({}, lst, ndvi, stats, window=WINDOW, factor=FACTOR,
                                         sr_step=step, step_params=params, device="cpu", **opts)

    lst, ndvi = inputs()
    tracing.enable()
    first = predict(lst, ndvi)
    (root,) = [r for r in tracing.records() if r["name"] == "predict_granule"]
    counts = root["counts"]
    gh, gw = lst.shape[0] // WINDOW, lst.shape[1] // WINDOW
    assert counts["blocks"] == counts["rows"] == counts["staged_rows"] == gh * gw
    assert first.dtype == np.float32 and first.shape == (gh * FWIN, gw * FWIN)
    want = _plain(lst, ndvi, step, params, **plain_opts)
    np.testing.assert_array_equal(first, want)
    if case == "coverage":
        assert np.all(first[:FWIN, FWIN:2 * FWIN] == 0.0)
        assert np.all(first[FWIN:, 2 * FWIN:] == 0.0) and np.all(first[FWIN:, :FWIN] > 0.0)

    lst2, ndvi2 = inputs(seed=12)
    second = predict(lst2, ndvi2)
    assert second is not first and not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, _plain(lst2, ndvi2, step, params, **plain_opts))


def test_grid_runs_cover_a_range_in_order():
    """Every range of a 4-wide grid of 3 rows splits into partial rows and
    whole rows that cover it once, in order."""
    gw, n = 4, 12
    grid = np.arange(n).reshape(3, gw)
    for start in range(n):
        for stop in range(start + 1, n + 1):
            got, at = [], start
            for i, j, rows, cols in inference._grid_runs(start, stop, gw):
                assert i == at and j > i
                part = grid[rows, cols]
                assert part.size == j - i
                assert (rows.stop - rows.start == 1) or (cols == slice(0, gw))
                got.extend(part.ravel())
                at = j
            assert at == stop and got == list(range(start, stop))


def _reading(blocks):
    rec = types.SimpleNamespace(requests=[{"blocks": b} for b in blocks],
                                trace={"spans": {"request": len(blocks)}})
    return core.load_part("metrics", "staged_row_share").read(rec)


def test_staged_row_share_reads_the_program_counter(stats):
    """The benchmark's reader on the program's own ring: 100 % where every
    row is stepped from the staging, nothing where no root counts
    ``staged_rows`` (a program without the counter)."""
    tracing.enable()
    for lst, ndvi in (_granule(), _strided()):
        inference.predict_granule({}, lst, ndvi, stats, batch_size=4, window=WINDOW,
                                  factor=FACTOR, sr_step=_stub_step, device="cpu")
    assert _reading([BLOCKS, BLOCKS]) == pytest.approx(100.0)
    for b in (1, 4):
        with tracing.root("predict_granule"):
            tracing.count("blocks", b)
            tracing.count("rows", b)
    assert _reading([1, 4]) is None


# ---- calls of 128 blocks or more: about four batches, each filled just before its step
LARGE = 8                      # the window of the large granules
LARGE_FWIN = LARGE * FACTOR


def _large(seed=11, gh=18, gw=18):
    """A gh x gw grid of blocks at window 8 (324 blocks at 18 x 18), the NDVI
    partly past [-1, 1]."""
    rng = np.random.default_rng(seed)
    lst = (296.0 + 20.0 * rng.random((gh * LARGE, gw * LARGE))).astype(np.float32)
    ndvi = (-0.2 + 1.4 * rng.random((4 * gh * LARGE, 4 * gw * LARGE))).astype(np.float32)
    return lst, ndvi


def _large_cloudy(seed=11):
    """324 blocks: block (0, 1) all 0 K, block (10, 5) a quarter, the last
    one half; the first and the third fail a coverage of 0.4."""
    lst, ndvi = _large(seed)
    lst = lst.copy()
    lst[0:8, 8:16] = 0.0
    lst[80:82, 40:48] = 0.0
    lst[140:144, 136:144] = 0.0
    return lst, ndvi


def _cloudy_144(seed=11):
    """The first 12 x 12 blocks of ``_large_cloudy``'s granule: at overlap 2
    its origins lie at stride 6, 16 x 16 of them."""
    lst, ndvi = _large_cloudy(seed)
    return lst[:12 * LARGE, :12 * LARGE], ndvi[:48 * LARGE, :48 * LARGE]


def _plain_overlap(lst, ndvi, step, params, batch_rows, overlap, coverage=1.0):
    """The overlap path's composition: the origins at stride window - overlap
    (the last flush with the edge), their blocks cut from the clipped
    granule, the step over the same batches, the coverage test, each kept
    block weighted by the separable trapezoid and summed in float64 in
    origin order, the sum over the weights."""
    ndvi = np.clip(ndvi, -1.0, 1.0)
    h, w = (s // LARGE * LARGE for s in lst.shape)
    ys = sorted(set(range(0, h - LARGE + 1, LARGE - overlap)) | {h - LARGE})
    xs = sorted(set(range(0, w - LARGE + 1, LARGE - overlap)) | {w - LARGE})
    origins = [(y, x) for y in ys for x in xs]
    lst_b = np.stack([lst[y:y + LARGE, x:x + LARGE] for y, x in origins])
    ndvi_b = np.stack([ndvi[FACTOR * y:FACTOR * (y + LARGE), FACTOR * x:FACTOR * (x + LARGE)]
                       for y, x in origins])
    lst_t, ndvi_t = torch.from_numpy(lst_b), torch.from_numpy(ndvi_b)
    out = torch.cat([step(params, lst_t[i:i + batch_rows], ndvi_t[i:i + batch_rows])
                     for i in range(0, len(origins), batch_rows)]).numpy()
    ramp = overlap * FACTOR
    taper_1d = np.ones(LARGE_FWIN, np.float32)
    taper_1d[:ramp] = np.linspace(1.0 / (ramp + 1), 1.0, ramp, endpoint=False)
    taper_1d[-ramp:] = taper_1d[:ramp][::-1]
    taper = np.outer(taper_1d, taper_1d)
    acc = np.zeros((FACTOR * h, FACTOR * w))
    wacc = np.zeros_like(acc)
    for k, (y, x) in enumerate(origins):
        if (lst_b[k] == 0).mean() <= coverage:
            sl = np.s_[FACTOR * y:FACTOR * y + LARGE_FWIN, FACTOR * x:FACTOR * x + LARGE_FWIN]
            acc[sl] += out[k] * taper
            wacc[sl] += taper
    return np.where(wacc > 0, acc / np.maximum(wacc, 1e-12), 0.0).astype(np.float32)


# inputs, predict_granule's options, the rows of each step call
LARGE_CASES = {
    "granule_324": (_large, {}, [81] * 4),
    "grid_144": (lambda seed=11: _large(seed, 12, 12), {}, [72] * 2),
    "grid_200": (lambda seed=11: _large(seed, 10, 20), {}, [67, 67, 66]),
    "capped_by_batch_size": (_large, dict(batch_size=50), [50] * 6 + [24]),
    "coverage": (_large_cloudy, dict(coverage=0.4), [81] * 4),
    "wire_int": (_large, dict(wire="int"), [81] * 4),
    "float32_step": (lambda seed=11: _large(seed, 12, 12), dict(step="float32"), [72] * 2),
    "overlap": (lambda seed=11: _large(seed, 12, 12), dict(overlap=4), [133] * 3 + [130]),
    "overlap_float32_step": (_cloudy_144, dict(overlap=2, coverage=0.4, step="float32"),
                             [64] * 4),
}


@pytest.mark.parametrize("case", list(LARGE_CASES))
def test_a_large_call_is_stepped_in_about_four_batches(stats, f32_step, case):
    """128 blocks (origins) or more go as about four equal batches of at
    least 64 rows, none above ``batch_size``; the mosaic is the composition's
    over the same batches bit for bit, and every row is stepped straight
    from the staging."""
    inputs, opts, want_rows = LARGE_CASES[case]
    opts = dict(opts)
    step, params = f32_step if opts.pop("step", None) == "float32" else (_stub_step, None)
    opts.setdefault("batch_size", 324)
    seen = []

    def recording(p, lst_b, ndvi_b):
        seen.append(lst_b.shape[0])
        assert ndvi_b.shape[0] == lst_b.shape[0]
        return step(p, lst_b, ndvi_b)

    lst, ndvi = inputs()
    tracing.enable()
    got = inference.predict_granule({}, lst, ndvi, stats, window=LARGE, factor=FACTOR,
                                    sr_step=recording, step_params=params, device="cpu", **opts)
    (root,) = [r for r in tracing.records() if r["name"] == "predict_granule"]
    assert seen == want_rows
    n = sum(want_rows)
    assert root["counts"]["blocks"] == root["counts"]["rows"] == root["counts"]["staged_rows"] == n
    if opts.get("overlap"):
        want = _plain_overlap(lst, ndvi, step, params, want_rows[0], opts["overlap"],
                              opts.get("coverage", 1.0))
    else:
        want = _plain(lst, ndvi, step, params, want_rows[0], opts.get("coverage", 1.0),
                      wire=opts.get("wire"), window=LARGE)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "coverage":
        f = LARGE_FWIN
        assert np.all(got[:f, f:2 * f] == 0.0) and np.all(got[-f:, -f:] == 0.0)
        assert np.all(got[10 * f:11 * f, 5 * f:6 * f] > 0.0)
