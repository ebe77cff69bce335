"""Readings that set a cell's correctness limits (not run by the
benchmark's own runs):

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds 11,12,... [--control-seeds 21,22,23] [--faults 31,32,33]

In one process, for each ``--seeds`` seed the program's compared numbers
(the lower readings), for each ``--control-seeds`` seed the control's (the
reference one precision below the configuration's, in the program's
place: the upper readings), and for each ``--faults`` seed the numbers
with each planted fault the cell can have. One JSON line each.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import core  # noqa: E402
from benchmark.run import HOST_THREADS, driver  # noqa: E402

import torch  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    torch.set_num_threads(HOST_THREADS)
    cell = core.load_cell(args.workload)
    kind = driver(cell)
    runs = [(s, "program", {}) for s in seeds(args.seeds)]
    runs += [(s, "control", {"control": True}) for s in seeds(args.control_seeds)]
    runs += [(s, f"fault:{f}", {"fault": f}) for s in seeds(args.faults) for f in kind.FAULTS]
    for seed, what, kw in runs:
        t0 = core.now()
        out = kind.run(cell, seed, args.seconds, False, "cuda", **kw)
        print(json.dumps({"workload": cell.name, "seed": seed, "run": what,
                          "attempted": out["attempted"],
                          "checks": {c.name: c.value for c in out["checks"]},
                          "passes": all(c.ok for c in out["checks"]),
                          "notes": out.get("notes"),
                          "seconds": core.now() - t0}), flush=True)
        del out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
