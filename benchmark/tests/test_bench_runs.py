"""Whole runs of every cell at a tiny size on the CPU, past the harness's
look for a card: set-up, window, reference comparison and the result
line; then the controls and the planted faults, which have to come out
as not correct."""

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.harness import core
from conftest import ROOT, tiny

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 3_000_000_019


def _run(name, trace=False, **kw):
    cell = core.load_cell(name)
    return run.execute(cell, SEED, 0.5, trace, "cpu", overrides=tiny(cell), **kw)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(name, trace, capsys):
    line, checks = _run(name, trace)
    core.emit(line, checks)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert set(out) - {"breakdown"} == {"correct", "attempted", "failed", "metrics", "device",
                                        "checks"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    cell = core.load_cell(name)
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end()}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:   # a CPU run writes no device number
        names = {m["name"] for m in cell.per_layer()
                 if m["source"] != "device_trace" and "mfu" not in m["name"]}
        assert set(out["metrics"]) <= names
    if cell.traffic["kind"] == "areas":
        assert out["correct"], out["checks"]


def test_int4_control_is_not_correct():
    line, checks = _run("int8-aoi", control=True)
    assert not line["correct"], [(c.name, c.value) for c in checks]


def test_tf32_control_is_not_correct():
    line, checks = _run("f32-granule", control=True)
    assert not line["correct"], [(c.name, c.value) for c in checks]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("name", ["int8-aoi", "f32-granule"])
def test_serving_faults_are_not_correct(name, fault):
    line, _ = _run(name, fault=fault)
    assert not line["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_training_faults_are_not_correct(fault):
    line, checks = _run("f32-train", fault=fault)
    assert not line["correct"], [(c.name, c.value) for c in checks]


def test_no_card_no_result(tmp_path):
    """Without a card: exit 2, nothing on stdout."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "int8-aoi",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                            "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    subprocess.run(["cp", "-r", str(ROOT / "benchmark"), str(ROOT / "BENCHMARK.json"),
                    str(tmp_path)], check=True)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "int8-aoi",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
