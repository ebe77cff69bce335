"""What every run shares: finding a cell's files by name, the set-up clock,
the device and isolation checks, the comparison limits, and the result
line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sifsr_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), so that set-up
    counts the interpreter's start and every import."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def caches_in_checkout() -> None:
    """Keep every compile cache at a fixed path inside the checkout (the
    port's nvcc libraries already live in ``sifsr_tpu_torch/build/``)."""
    cache = BENCH_DIR / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict         # the cell's entry in BENCHMARK.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    workload: dict      # workloads/<cell>.json
    bench: dict         # BENCHMARK.json

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in e2e else [])]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    return Cell(name, entry, load_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
                load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
                load_json(BENCH_DIR / "workloads" / f"{name}.json"), bench)


def load_part(folder: str, name: str):
    """The module ``benchmark/<folder>/<name>.py``: a traffic kind's driver,
    a serving step, a control or a per-layer metric, found by its name."""
    key = f"benchmark_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        path = BENCH_DIR / folder / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"no {path.relative_to(ROOT)} for {name!r}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod       # before it runs: its dataclasses look it up
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``sifsr_tpu_torch`` is not ``sifsr_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Check:
    """One compared number and its limit: passes when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def emit(result: dict, checks: list[Check]) -> None:
    """The compared numbers as the last lines of stderr and as the result
    line's last key; the result as the last line of stdout."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


class DeviceTimer:
    """CUDA events around a block: its device seconds once the device has
    passed the end event. On a CPU device it times nothing (``seconds``
    is None): no device number comes from a CPU run."""

    def __init__(self, device):
        import torch
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self._cuda:
            self._start.record()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            self._end.record()

    def seconds(self):
        return self._start.elapsed_time(self._end) * 1e-3 if self._cuda else None


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def now() -> float:
    return time.perf_counter()
