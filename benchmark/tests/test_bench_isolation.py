"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: ``sifsr_tpu_torch`` is not ``sifsr_tpu``), and the
reference and the controls load nothing of the program."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "sifsr_tpu")

HARNESS = """
import glob, importlib, importlib.util, json, os, sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.control
from benchmark.harness import core
for mod in ("core", "seeded", "trace", "yardstick"):
    importlib.import_module("benchmark.harness." + mod)
for folder in ("traffic", "steps", "controls", "metrics"):
    for path in sorted(glob.glob(os.path.join({root!r}, "benchmark", folder, "*.py"))):
        core.load_part(folder, os.path.basename(path)[:-3])
for path in sorted(glob.glob(os.path.join({root!r}, "benchmark", "configs", "*.json"))):
    json.load(open(path))
# what the drivers load of the program
for mod in ("cli.predict", "inference", "models.fused", "models.unet", "train.step",
            "train.state", "data.datasets", "data.statistics", "kernels"):
    importlib.import_module("sifsr_tpu_torch." + mod)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
import benchmark.reference.modelb2, benchmark.reference.train, benchmark.reference.weights
from benchmark.harness.core import load_part
for path in sorted(glob.glob(os.path.join({root!r}, "benchmark", "controls", "*.py"))):
    load_part("controls", os.path.basename(path)[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                       capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "benchmark" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & set(FORBIDDEN + ("sifsr_tpu_torch",))


def test_a_run_checks_the_names_whole():
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core
    before = dict(sys.modules)
    try:
        sys.modules["sifsr_tpu_torch_lookalike"] = sys
        assert "sifsr_tpu_torch_lookalike" not in core.forbidden_modules()
        sys.modules["flax.core"] = sys
        assert "flax.core" in core.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
