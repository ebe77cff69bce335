"""BENCHMARK.json against the contract's rules on names, units and keys,
and every name it gives to a file the harness finds."""

import json
import re

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert "\n" not in m.get("layer", "") and "\t" not in m.get("layer", "")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_has_its_file():
    root = core.ROOT
    for c in BENCH["configs"]:
        assert (root / c["file"]).is_file()
        assert json.loads((root / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = core.load_cell(w["name"])
        assert (core.BENCH_DIR / "traffic" / f"{cell.traffic['kind']}.py").is_file()
        assert (core.BENCH_DIR / "controls" / f"{cell.config['control']}.py").is_file()
        if cell.traffic["kind"] == "areas":
            assert (core.BENCH_DIR / "steps" / f"{cell.config['serve']['step']}.py").is_file()
        assert "cpu_test" in cell.workload
    for m in BENCH["per_layer"]:
        assert (core.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_metric_workloads_are_the_cells_that_report_them():
    """A metric's ``workloads`` list exactly the cells that report it, and
    each per-layer metric's cells report the end-to-end metric it moves."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    reports = {c: {m["name"] for m in core.load_cell(c).end_to_end()} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert core.load_cell(c).per_layer()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
        reporting = {c for c in cells
                     if m["name"] in {p["name"] for p in core.load_cell(c).per_layer()}}
        assert reporting == set(m["workloads"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
