"""ctypes bindings for the native raster loader (``csrc/sifsr_native.cpp``).

Port of ``sifsr_tpu/data/native_loader.py``. The library is the port's own
copy of the JAX package's classic-TIFF decoder (strips; compression none or
deflate; float and int samples) with a pthread batch pool. On first use it is
built by ``g++ -O3 -shared -fPIC ... -lz -lpthread`` into
``sifsr_tpu_torch/build/``, named by a hash of its source and flags (as
``kernels/_build.py`` names the CUDA libraries), and loaded with ctypes.

Where no toolchain exists (no ``g++`` or no ``zlib.h``) every function falls
back to the pure-Python reader of ``geo/tiff.py``, as the JAX package does;
the API is the same either way. Where both exist, a failed build or load is
an error, not a fallback.

    batch = load_batch(paths, height=64, width=64, mean=295.0, std=10.0,
                       n_threads=8)   # (N, H, W) float32, decoded in parallel
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from sifsr_tpu_torch.geo.tiff import read_geotiff

__all__ = ["native_available", "toolchain_available", "library_path", "read_tiff",
           "load_batch"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "sifsr_native.cpp"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False

# csrc/sifsr_native.cpp return code: valid file, unsupported layout
_ERR_UNSUPPORTED = -3


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"sifsr_native-{h.hexdigest()[:16]}.so"


def toolchain_available() -> bool:
    """True when ``g++`` is on the PATH and preprocesses ``#include <zlib.h>``."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                           capture_output=True, text=True)
    return probe.returncode == 0


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [shutil.which("g++"), *GXX_FLAGS, "-o", tmp, str(_SRC), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ {_SRC.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: two processes building at once each load a whole copy


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.sifsr_tiff_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sifsr_tiff_info.restype = ctypes.c_int
    lib.sifsr_tiff_read_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.sifsr_tiff_read_f32.restype = ctypes.c_int
    lib.sifsr_load_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
    ]
    lib.sifsr_load_batch_f32.restype = ctypes.c_int
    return lib


def _load_library():
    """The loaded library, built first if needed; None without a toolchain.
    Raises when the toolchain is there and the build or the load fails."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        path = library_path()
        if not path.exists():
            if not toolchain_available():
                _tried = True
                return None
            _build(path)
        _lib = _bind(path)
        _tried = True
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def _read_python(path: str) -> np.ndarray:
    return read_geotiff(path).array.astype(np.float32)


def read_tiff(path: str) -> np.ndarray:
    """Decode one TIFF to float32 (native fast path, Python fallback).

    Single-band files return (H, W). Layouts the native decoder does not do
    (tiled, PackBits, multi-band, other sample types) go through the Python
    reader; multi-band then returns (H, W, S)."""
    lib = _load_library()
    if lib is None:
        return _read_python(path)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.sifsr_tiff_info(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc == _ERR_UNSUPPORTED:
        # a valid TIFF in a layout the fast path does not do: the Python
        # reader takes it. Corrupt files (other codes) still raise.
        return _read_python(path)
    if rc != 0:
        raise IOError(f"sifsr_tiff_info({path}) -> {rc}")
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.sifsr_tiff_read_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
    )
    if rc != 0:
        raise IOError(f"sifsr_tiff_read_f32({path}) -> {rc}")
    return out


def _read_band1(path: str) -> np.ndarray:
    """Python single-raster read with a clear error for multi-band inputs
    (geo/tiff.py returns (H, W, S) for those; training batches are
    single-band by contract)."""
    arr = read_geotiff(path).array
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a single-band raster, got {arr.shape[-1]} bands")
    return arr.astype(np.float32)


def load_batch(
    paths: list[str],
    height: int,
    width: int,
    mean: float = 0.0,
    std: float = 1.0,
    n_threads: int = 8,
) -> np.ndarray:
    """Decode and normalise a batch of same-shape TIFFs concurrently."""
    lib = _load_library()
    if lib is None:
        out = np.stack([_read_band1(p) for p in paths])
        return (out - mean) / std

    out = np.empty((len(paths), height, width), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.sifsr_load_batch_f32(
        arr,
        len(paths),
        height,
        width,
        ctypes.c_float(mean),
        ctypes.c_float(1.0 / std),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    if rc == _ERR_UNSUPPORTED:
        # some member uses a layout the native path does not do: the whole
        # batch goes through the Python reader
        full = np.stack([_read_band1(p) for p in paths])
        if full.shape[1:] != (height, width):
            raise IOError(f"load_batch: decoded shape {full.shape[1:]} != ({height}, {width})")
        return (full - mean) / std
    if rc != 0:
        raise IOError(f"sifsr_load_batch_f32 -> {rc}")
    return out
