"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``sifsr_tpu_torch/build/``, named by a hash of its source, the shared
``csrc/*.cuh`` headers and the flags, so that an edited source is rebuilt, and loaded with
``ctypes``. ``build()`` compiles several sources at once, one ``nvcc``
process each, all started together. ptxas reports each kernel's registers,
spills and static shared memory (``-Xptxas -v``); the report is kept beside
the library and read by ``ptxas_report()``.

Wrappers pass device pointers (``tensor.data_ptr()``) and the current
stream as ``c_void_p``; every C entry point returns ``cudaGetLastError()``
after its launch, and ``check()`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build", "load", "check", "ptxas_report"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

BUILD_DIR = _PKG / "build"

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[Path, Path]:
    """Source and library path; the hash covers every ``csrc/*.cuh`` header
    as well, so that an edited header rebuilds the sources that include it."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: all of ``csrc/*.cu``) that have no
    current library yet, in parallel. Returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    out = {name: _target(name)[1] for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        src, lib = _target(name)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            os.unlink(tmp)
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.sifsr_error_string.argtypes = [ctypes.c_int]
        lib.sifsr_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.sifsr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptxas_report(name: str) -> list[dict]:
    """ptxas's account of each kernel of ``csrc/<name>.cu`` from its last
    build: [{kernel (mangled), registers, spill_stores, spill_loads,
    stack, smem_static}] in bytes where not a count."""
    log = _target(name)[1].with_suffix(".log").read_text()
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": None,
                   "spill_loads": None, "stack": None, "smem_static": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_static"] = int(m.group(1))
    return out
