"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the first timed request or step) and the
measured window, then the comparison with the plain reference. The last
line of stdout is the result: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), ``device`` and, traced, ``breakdown``; its last key,
``checks``, holds each compared number beside its limit, which also end
stderr. Without a CUDA card, or with fewer than the cell asks for, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import core  # noqa: E402

core.caches_in_checkout()

import torch  # noqa: E402

# one host thread for torch's CPU work: with the card machine's eight, a
# granule cell's runs spread about three times as widely (PERF.md, Findings)
HOST_THREADS = 1


def reader(metric: str):
    """The per-layer metric's reader, ``benchmark/metrics/<metric>.py``."""
    return core.load_part("metrics", metric).read


def driver(cell: core.Cell):
    """The cell's traffic kind, ``benchmark/traffic/<kind>.py``: its
    generator and driver."""
    return core.load_part("traffic", cell.traffic["kind"])


def result_line(cell: core.Cell, out: dict, trace: bool, device) -> dict:
    from benchmark.harness.trace import breakdown

    rec = out["record"]
    metrics = {}
    if not trace:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            if device.type != "cuda" and (m["source"] == "device_trace" or "mfu" in m["name"]):
                continue            # no device number comes from a CPU run
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": all(c.ok for c in out["checks"]) and out["failed"] == 0
            and out["attempted"] > 0,
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": dev}
    if trace and rec.trace and cuda:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        line["breakdown"] = breakdown(rec.trace)
    return line


def execute(cell: core.Cell, seed: int, seconds: float, trace: bool, device, **kw):
    """One run of a cell: (the result line without ``checks``, the checks).
    ``kw`` goes to the driver (sizes and planted faults for the tests)."""
    out = driver(cell).run(cell, seed, seconds, trace, device, **kw)
    return result_line(cell, out, trace, torch.device(device)), out["checks"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        core.log(f"{args.workload} needs {cell.entry['chips']} CUDA card(s); "
                 f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    torch.set_num_threads(HOST_THREADS)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, checks = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    found = core.forbidden_modules()
    if found:
        core.log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    core.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
