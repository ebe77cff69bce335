"""The port's serving daemon: spool drain, output, per-job failure isolation,
grace window and order (tests/test_serve.py mirrored), the calibration kept
across jobs, and the output against the JAX daemon's."""

import json
import os

import numpy as np
import pytest

from sifsr_tpu_torch.cli import serve
from sifsr_tpu_torch.geo.tiff import read_geotiff, write_geotiff

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
COMMON = ["--model_dir", os.path.join(ROOT, "weights", "modelB_1009"),
          "--statistics", os.path.join(ROOT, "data", "statistics_testset.json"),
          "--batch_size", "2"]


def _scene(tmp_path, rng, name, shift=0.0):
    lst = (292.0 + shift + 16.0 * rng.random((64, 128))).astype(np.float32)
    ndvi = (rng.random((256, 512)) * 0.8 - 0.05).astype(np.float32)
    paths = str(tmp_path / f"{name}_lst.tif"), str(tmp_path / f"{name}_ndvi.tif")
    write_geotiff(paths[0], lst, geotransform=(0.0, 926.6, 0.0, 0.0, 0.0, -926.6))
    write_geotiff(paths[1], ndvi, geotransform=(0.0, 231.65, 0.0, 0.0, 0.0, -231.65))
    return paths


def _job(watch, name, lst, ndvi, out=None, mtime=None):
    job = {"lst": lst, "ndvi": ndvi, "ndvi_is_precomputed": True}
    if out:
        job["out"] = out
    p = watch / name
    p.write_text(json.dumps(job))
    if mtime:
        os.utime(p, (mtime, mtime))


def test_serve_once_drains_spool_like_jax(tmp_path, rng, capsys):
    """--once --f32 on a spool with a good job, a missing file and broken
    JSON; the good job's raster equals the JAX daemon's to the float32
    step's tolerance (rtol 1e-5 / atol 2e-4 K)."""
    from sifsr_tpu.cli.serve import main as jax_main

    lst, ndvi = _scene(tmp_path, rng, "a")
    outs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", serve.main, ["--device", "cpu"])):
        watch = tmp_path / f"jobs_{name}"
        watch.mkdir()
        outs[name] = str(tmp_path / f"out_{name}" / "a.tiff")
        _job(watch, "a_good.json", lst, ndvi, outs[name])
        _job(watch, "b_bad.json", str(tmp_path / "missing.tif"), ndvi)
        (watch / "c_not_json.json").write_text("{nope")
        main(["--watch", str(watch), "--f32", "--pad-impl", "explicit", "--once", *COMMON, *extra])
        assert (watch / "done" / "a_good.json").exists() and not (watch / "a_good.json").exists()
        for stem in ("b_bad", "c_not_json"):
            assert (watch / "failed" / f"{stem}.json").exists()
            assert (watch / "failed" / f"{stem}.err").read_text().strip()
    log = capsys.readouterr().out
    assert "[serve] --once: processed 3 job(s)" in log and "(path=f32)" in log
    got, want = read_geotiff(outs["port"]), read_geotiff(outs["jax"])
    assert got.array.shape == (256, 512)
    np.testing.assert_allclose(got.array, want.array, rtol=1e-5, atol=2e-4)
    assert got.geotransform == want.geotransform
    assert 260.0 < got.array.mean() < 330.0


def test_serve_pallas_calibrates_once(tmp_path, rng, monkeypatch):
    """--pallas: the int8 parameters are built on the first granule with
    valid blocks and reused; a granule of 0 K fill fails its own job before
    that; outputs land in <watch>/done/ by default."""
    calls = []
    real = serve.make_quantized_step

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(serve, "make_quantized_step", counting)
    watch = tmp_path / "jobs"
    watch.mkdir()
    empty = str(tmp_path / "empty_lst.tif")
    write_geotiff(empty, np.zeros((64, 128), np.float32))
    first, second = _scene(tmp_path, rng, "a"), _scene(tmp_path, rng, "b", shift=2.0)
    _job(watch, "0_empty.json", empty, first[1], mtime=1000.0)
    _job(watch, "1_first.json", *first, mtime=1001.0)
    _job(watch, "2_second.json", *second, mtime=1002.0)
    serve.main(["--watch", str(watch), "--pallas", "--once", "--device", "cpu", *COMMON])
    assert len(calls) == 2                     # the failed attempt and the one that was kept
    assert "fully-valid" in (watch / "failed" / "0_empty.err").read_text()
    for stem in ("1_first", "2_second"):
        out = read_geotiff(str(watch / "done" / f"{stem}.tiff"))
        assert out.array.shape == (256, 512) and 270.0 < out.array.min() < out.array.max() < 330.0


def test_drain_grace_window_and_order(tmp_path):
    """_drain skips files younger than the grace window (half-written
    producers) and processes the backlog oldest-first by mtime."""

    class StubServer:
        def __init__(self):
            self.seen = []

        def process(self, job, default_out):
            self.seen.append(job["id"])
            return default_out

    watch = tmp_path / "spool"
    watch.mkdir()
    for i, name in enumerate(["z_first.json", "m_second.json", "a_third.json"]):
        p = watch / name
        p.write_text(json.dumps({"id": name.split("_")[0]}))
        os.utime(p, (1000.0 + i, 1000.0 + i))
    fresh = watch / "fresh.json"
    fresh.write_text(json.dumps({"id": "fresh"}))  # now-mtime: inside grace

    server = StubServer()
    n = serve._drain(server, str(watch), lambda *a: None, grace=30.0)
    assert server.seen == ["z", "m", "a"]
    assert n == 3
    assert fresh.exists()  # left for the next poll

    for i, name in enumerate(["j1.json", "j2.json"]):
        p = watch / name
        p.write_text(json.dumps({"id": name}))
        os.utime(p, (2000.0 + i, 2000.0 + i))
    server2 = StubServer()
    calls = {"n": 0}

    def stop_after_one():
        calls["n"] += 1
        return calls["n"] > 1

    serve._drain(server2, str(watch), lambda *a: None, should_stop=stop_after_one, grace=30.0)
    assert server2.seen == ["j1.json"]


def test_drain_survives_bad_input_and_vanished_job(tmp_path):
    """Per-job isolation holds for library-level input errors and when the
    failure-isolation move itself races a second consumer that removed the
    job file."""
    watch = tmp_path / "spool"
    watch.mkdir()
    for i, name in enumerate(["a_bad.json", "b_vanishes.json", "c_good.json"]):
        p = watch / name
        p.write_text(json.dumps({"id": name.split("_")[0]}))
        os.utime(p, (1000.0 + i, 1000.0 + i))

    class StubServer:
        def __init__(self):
            self.seen = []

        def process(self, job, default_out):
            self.seen.append(job["id"])
            if job["id"] == "a":
                raise ValueError("3-band tif: expected exactly 2 bands")
            if job["id"] == "b":
                os.unlink(watch / "b_vanishes.json")  # racing consumer
                raise RuntimeError("boom")
            return default_out

    logs = []
    server = StubServer()
    n = serve._drain(server, str(watch), logs.append, grace=30.0)
    assert server.seen == ["a", "b", "c"]  # nothing killed the drain
    assert n == 3
    assert (watch / "failed" / "a_bad.json").exists()
    assert "2 bands" in (watch / "failed" / "a_bad.err").read_text()
    assert any("could not be spooled" in m for m in logs)
    assert (watch / "done" / "c_good.json").exists()


def test_serve_defaults_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--watch", str(tmp_path / "jobs"), "--once", *COMMON])
