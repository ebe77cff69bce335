"""Each per-layer reader's arithmetic on a synthetic record and trace:
every share stays within 0-100 %, and a reader with nothing to read
returns nothing."""

import types

import pytest

from benchmark import run
from benchmark.harness import core, trace

MS = 1_000_000  # ns


class Timer:
    def __init__(self, s):
        self.s = s

    def seconds(self):
        return self.s


def _trace(rows=324, steps=3, step_ms=5.2, drop=0):
    """A window of ``steps`` int8 steps of ``step_ms`` each, 200 ms apart:
    in each, the step's 19 hand-written kernel launches (``drop`` fewer)
    and one library kernel, back to back in 20 equal parts, plus a copy."""
    from benchmark.harness import yardstick
    launches = len(yardstick.int8_step_launches(rows)) - drop
    part = int(step_ms / 20 * MS)
    ev = [("window", False, True, 0, 1000 * MS)]
    for i in range(steps):
        t = i * 200 * MS
        ev.append(("request", False, True, t, t + 190 * MS))
        ev.append(("sr_step", False, True, t + 46 * MS, t + 59 * MS))
        k = t + 60 * MS
        names = ["void conv_prow_mma_kernel<>(x)"] * launches + [
            "at::native::vectorized_elementwise_kernel"] * (20 - launches)
        for name in names:
            ev.append((name, True, False, k, k + part))
            k += part
        ev.append(("Memcpy HtoD (Pinned -> Device)", True, False, t + 40 * MS, t + 45 * MS))
        ev.append(("gpu annotation", True, True, t, t + 190 * MS))   # not device work
    return trace.reduce_events(ev)


def _serve_record(cell_name="int8-aoi", traced=True):
    cell = core.load_cell(cell_name)
    rec = types.SimpleNamespace(cell=cell, window_s=1.0, samples=3 * 324, steps=3,
                                requests=[{"blocks": 324, "seconds": 0.19, "step_s": 0.0052}] * 3,
                                step_calls=[(324, Timer(0.0052))] * 3,
                                trace=_trace() if traced else None)
    return cell, rec


def test_reduce_events():
    t = _trace()
    assert t["window_s"] == pytest.approx(1.0)
    assert t["busy_s"] == pytest.approx(3 * (0.0052 + 0.005), rel=1e-3)
    assert t["spans"]["request"] == 3 and t["spans"]["sr_step"] == 3
    assert sum(t["idle"].values()) == pytest.approx(1.0 - t["busy_s"])
    assert set(t["idle"]) == {"idle in request", "idle outside any call", "idle in request/sr_step"}
    bd = trace.breakdown(t)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert bd["idle_gaps"][0][1] == max(t["idle"].values())


def test_serving_readers_in_range():
    cell, rec = _serve_record()
    got = {m["name"]: run.reader(m["name"])(rec) for m in cell.per_layer()}
    assert set(got) == {"granule_host_ms", "serve_step_ms", "serve_mfu", "useful_block_share.aoi",
                        "int8_kernel_roofline", "device_idle_share.serve"}
    assert got["granule_host_ms"] == pytest.approx(190 - 5.2)
    assert got["serve_step_ms"] == pytest.approx(5.2)
    for name in ("serve_mfu", "int8_kernel_roofline", "device_idle_share.serve"):
        assert 0.0 < got[name] <= 100.0, name
    # bounds of 3 steps over the 19 mapped launches' 19/20 of 3 x 5.2 ms
    from benchmark.harness import yardstick
    bound = 3 * sum(yardstick.launch_bound_s(b, o) for _, b, o in yardstick.int8_step_launches(324))
    assert got["int8_kernel_roofline"] == pytest.approx(100 * bound / (3 * 0.95 * 5.2e-3),
                                                        rel=1e-3)
    assert got["device_idle_share.serve"] == pytest.approx(100 * (1 - 3 * 0.0102), rel=1e-3)


def test_roofline_needs_every_launch_of_the_table():
    """A launch renamed or moved into a library kernel takes its time out
    of the sum while the table still bounds its work: no reading."""
    cell, rec = _serve_record()
    rec.trace = _trace(drop=1)
    assert run.reader("int8_kernel_roofline")(rec) is None


def test_aoi_useful_share():
    cell, rec = _serve_record("int8-aoi")
    rec.samples, rec.step_calls = 64, [(324, Timer(0.005))] * 10
    assert run.reader("useful_block_share.aoi")(rec) == pytest.approx(100 * 64 / 3240)


def test_readers_return_nothing_without_a_trace():
    cell, rec = _serve_record(traced=False)
    assert run.reader("int8_kernel_roofline")(rec) is None
    assert run.reader("device_idle_share.serve")(rec) is None
    rec.step_calls = [(324, Timer(None))]
    assert run.reader("serve_step_ms")(rec) is None


def test_training_readers_in_range():
    cell = core.load_cell("f32-train")
    rec = types.SimpleNamespace(cell=cell, window_s=10.0, samples=32 * 160, steps=160,
                                step_timers=[Timer(0.06)] * 160, trace=_trace())
    got = {m["name"]: run.reader(m["name"])(rec) for m in cell.per_layer()}
    assert set(got) == {"train_step_ms", "train_mfu", "device_idle_share.train"}
    assert got["train_step_ms"] == pytest.approx(60.0)
    assert got["train_mfu"] == pytest.approx(100 * 512 * 3 * 3_605_004_288 / 67e12)
    for v in (got["train_mfu"], got["device_idle_share.train"]):
        assert 0.0 < v <= 100.0
