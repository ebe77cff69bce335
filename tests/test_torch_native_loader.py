"""The port's native raster loader and StreamingModisDataset against the JAX
package's, on seeded GeoTIFFs written here (raw and deflate strips, float32
and int16): decodes bit-equal, the same refusals of corrupt files, the same
routing of layouts the native decoder does not take, the library built under
``sifsr_tpu_torch/build/`` and ``native/`` left alone, and the streaming
dataset's batches, errors and producer thread. No timing is asserted: the
decode rates are measured on the card machine by chip_smoke.py phase 11."""

import hashlib
import os
import struct
import threading
import time

import numpy as np
import pytest

from sifsr_tpu.data import native_loader as jax_loader
from sifsr_tpu.data.datasets import StreamingModisDataset as JaxStreaming
from sifsr_tpu.data.statistics import Statistics as JaxStatistics

from sifsr_tpu_torch.data import ModisDataset, Statistics, StreamingModisDataset
from sifsr_tpu_torch.data import native_loader
from sifsr_tpu_torch.geo.tiff import read_geotiff

from chip_smoke import write_strip_tiff, write_training_manifest
from tests.test_geo_tiff import _build_multiband_tiff, _build_tiled_tiff

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
JAX_SO = os.path.join(ROOT, "native", "libsifsr_native.so")
STATS = dict(maxi=330.0, mini=260.0, mean_lst=295.0, std_lst=10.0, mean_ndvi=0.3,
             std_ndvi=0.25)


def _files(tmp_path, rng, dtype, n=6, shape=(24, 40)):
    """n seeded rasters, alternating raw single strips and deflate strips of
    5 rows (the last strip short)."""
    paths, arrays = [], []
    for i in range(n):
        if dtype == np.int16:
            arr = rng.integers(-30000, 30000, shape).astype(np.int16)
        else:
            arr = (290 + 20 * rng.random(shape)).astype(np.float32)
        p = str(tmp_path / f"{dtype.__name__}_{i}.tif")
        deflate = i % 2 == 1
        write_strip_tiff(p, arr, 5 if deflate else None, deflate)
        paths.append(p)
        arrays.append(arr)
    return paths, arrays


def test_the_port_builds_its_own_library_and_leaves_native_alone():
    """The library lives under sifsr_tpu_torch/build/, named by a hash of its
    source; native/libsifsr_native.so keeps its bytes and mtime."""
    before = (hashlib.sha256(open(JAX_SO, "rb").read()).hexdigest(), os.stat(JAX_SO).st_mtime_ns)
    assert native_loader.toolchain_available()   # g++ and zlib.h on this machine
    assert native_loader.native_available()
    lib = native_loader.library_path()
    assert lib.exists() and lib.parent == native_loader.BUILD_DIR
    assert lib.parent.name == "build" and lib.parent.parent.name == "sifsr_tpu_torch"
    assert lib.name.startswith("sifsr_native-") and lib.suffix == ".so"
    src = open(os.path.join(ROOT, "sifsr_tpu_torch", "csrc", "sifsr_native.cpp")).read()
    assert src.replace("sifsr_tpu_torch.data", "sifsr_tpu.data") == open(
        os.path.join(ROOT, "native", "sifsr_native.cpp")).read()
    after = (hashlib.sha256(open(JAX_SO, "rb").read()).hexdigest(), os.stat(JAX_SO).st_mtime_ns)
    assert after == before


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_read_tiff_and_load_batch_bit_equal_to_jax(tmp_path, rng, dtype):
    """Raw and deflate strips, float32 and int16, with and without the
    normalisation: the port's arrays are the JAX package's, bit for bit
    (the same C++ behind both), and the rasters' own values."""
    paths, arrays = _files(tmp_path, rng, dtype)
    for p, arr in zip(paths, arrays):
        got = native_loader.read_tiff(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_loader.read_tiff(p))
        np.testing.assert_array_equal(got, arr.astype(np.float32))
    for mean, std in ((0.0, 1.0), (295.0, 10.0)):
        got = native_loader.load_batch(paths, 24, 40, mean=mean, std=std, n_threads=3)
        want = jax_loader.load_batch(paths, 24, 40, mean=mean, std=std, n_threads=3)
        assert got.shape == (6, 24, 40) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, (np.stack(arrays) - 295.0) / 10.0, rtol=1e-6)


def _strip_offset_field(data):
    endian = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(endian + "I", data[4:8])
    (n,) = struct.unpack(endian + "H", data[ifd:ifd + 2])
    for i in range(n):
        e = ifd + 2 + 12 * i
        if struct.unpack(endian + "H", data[e:e + 2])[0] == 273:
            return e + 8, endian
    raise AssertionError("no StripOffsets tag")


@pytest.mark.parametrize("case", ["lying_offset", "truncated", "garbage", "empty"])
def test_corrupt_files_raise_in_both_packages(tmp_path, rng, case):
    """tests/test_native_loader.py's refusals: a strip offset past the end, a
    truncated file, garbage and an empty file raise IOError, as in JAX."""
    good = str(tmp_path / "good.tif")
    write_strip_tiff(good, rng.normal(size=(16, 16)).astype(np.float32))
    data = bytearray(open(good, "rb").read())
    bad = tmp_path / f"{case}.tif"
    if case == "lying_offset":
        field, endian = _strip_offset_field(data)
        data[field:field + 4] = struct.pack(endian + "I", len(data) + 4096)
        bad.write_bytes(bytes(data))
    elif case == "truncated":
        bad.write_bytes(bytes(data[: len(data) // 2]))
    elif case == "garbage":
        bad.write_bytes(b"\x89PNG\r\n\x1a\nnot a tiff at all" * 4)
    else:
        bad.write_bytes(b"")
    for loader in (native_loader, jax_loader):
        with pytest.raises(IOError):
            loader.read_tiff(str(bad))
        with pytest.raises(IOError):
            loader.load_batch([good, str(bad)], 16, 16)


def test_unsupported_layouts_route_to_the_python_reader(tmp_path, rng):
    """A multi-band file and a tiled one are valid TIFFs the native decoder
    does not take: read_tiff decodes them through geo/tiff.py as JAX does
    (multi-band as (H, W, S)), load_batch redoes a batch with a tiled member
    in Python and refuses a multi-band member with ValueError."""
    multi = tmp_path / "multi.tif"
    arr3 = rng.normal(size=(12, 10, 3)).astype(np.float32)
    multi.write_bytes(_build_multiband_tiff(arr3))
    got = native_loader.read_tiff(str(multi))
    assert got.shape == (12, 10, 3)
    np.testing.assert_array_equal(got, jax_loader.read_tiff(str(multi)))
    np.testing.assert_array_equal(got, arr3)

    arr = rng.normal(size=(24, 40)).astype(np.float32)
    tiled = str(tmp_path / "tiled.tif")
    with open(tiled, "wb") as f:
        f.write(_build_tiled_tiff(arr, 16, 16, compress=True))
    strip = str(tmp_path / "strip.tif")
    write_strip_tiff(strip, arr, 7, deflate=True)
    np.testing.assert_array_equal(native_loader.read_tiff(tiled), arr)
    got = native_loader.load_batch([strip, tiled], 24, 40, mean=1.0, std=2.0)
    np.testing.assert_array_equal(got, jax_loader.load_batch([strip, tiled], 24, 40, mean=1.0,
                                                             std=2.0))
    np.testing.assert_allclose(got, np.stack([(arr - 1.0) / 2.0] * 2), rtol=1e-6)

    band = str(tmp_path / "band.tif")
    write_strip_tiff(band, rng.normal(size=(12, 10)).astype(np.float32))
    for loader in (native_loader, jax_loader):
        with pytest.raises(ValueError, match="single-band"):
            loader.load_batch([band, str(multi)], 12, 10)


def test_failed_build_raises_and_no_toolchain_falls_back(tmp_path, rng, monkeypatch):
    """With g++ and zlib.h present a build that fails is an error, not a
    quiet False; without a toolchain every function takes the Python reader
    (the JAX package's documented fallback)."""
    broken = tmp_path / "sifsr_native.cpp"
    broken.write_text("#include <zlib.h>\nint this is not C++;\n")
    monkeypatch.setattr(native_loader, "_SRC", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_tried", False)
    for _ in range(2):   # and again: a failure is not remembered as "absent"
        with pytest.raises(RuntimeError, match="g\\+\\+ sifsr_native.cpp failed"):
            native_loader.native_available()
    assert not list((tmp_path / "build").glob("*.so"))

    monkeypatch.setattr(native_loader, "toolchain_available", lambda: False)
    assert native_loader.native_available() is False
    paths, arrays = _files(tmp_path, rng, np.float32, n=3)
    np.testing.assert_array_equal(native_loader.read_tiff(paths[1]), arrays[1])
    got = native_loader.load_batch(paths, 24, 40, mean=295.0, std=10.0)
    np.testing.assert_allclose(got, (np.stack(arrays) - 295.0) / 10.0, rtol=1e-6)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """chip_smoke.py phase 11's manifest writer at a small size: 7 Train and
    3 Val pairs, raw and deflate strips."""
    return write_training_manifest(str(tmp_path_factory.mktemp("patches")), 7, 3, seed=4)


@pytest.mark.parametrize("split,batch,drop", [("Train", 2, True), ("Train", 3, False),
                                              ("Val", 2, False)])
def test_streaming_batches_equal_materialised_and_jax(manifest, split, batch, drop):
    """StreamingModisDataset yields ModisDataset's batches for the seed, bit
    for bit, and the JAX package's StreamingModisDataset's."""
    csv_path, _ = manifest
    stats = Statistics(**STATS)
    mat = ModisDataset(csv_path, stats, split=split)
    stream = StreamingModisDataset(csv_path, stats, split=split, prefetch=2, n_threads=3)
    jax_stream = JaxStreaming(csv_path, JaxStatistics(**STATS), split=split)
    assert len(stream) == len(mat) == len(jax_stream)
    assert stream.n_batches(batch, drop) == mat.n_batches(batch, drop)
    got = list(stream.batches(batch, seed=13, drop_remainder=drop))
    want = list(mat.batches(batch, seed=13, drop_remainder=drop))
    jax_want = list(jax_stream.batches(batch, seed=13, drop_remainder=drop))
    assert len(got) == len(want) == len(jax_want) == stream.n_batches(batch, drop)
    for g, w, j in zip(got, want, jax_want):
        assert set(g) == {"lst", "ndvi"} and g["lst"].shape[1:] == (64, 64, 1)
        assert g["ndvi"].shape[1:] == (256, 256, 1) and g["lst"].dtype == np.float32
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], j[k])


def test_modis_dataset_decodes_as_the_python_reader(manifest):
    """ModisDataset through the native pool equals the Python reader's
    normalised rasters."""
    csv_path, _ = manifest
    stats = Statistics(**STATS)
    ds = ModisDataset(csv_path, stats)
    lst = np.stack([read_geotiff(p).array for p, _ in ds.paths])
    ndvi = np.stack([read_geotiff(p).array for _, p in ds.paths])
    np.testing.assert_array_equal(ds.lst, (lst - stats.mean_lst) / stats.std_lst)
    np.testing.assert_array_equal(ds.ndvi, (ndvi - stats.mean_ndvi) / stats.std_ndvi)


def test_streaming_decode_error_surfaces_in_the_consumer(tmp_path):
    manifest = tmp_path / "manifest.csv"
    manifest.write_text(f"LST,NDVI,split\n{tmp_path / 'missing.tif'},"
                        f"{tmp_path / 'missing2.tif'},Train\n")
    stream = StreamingModisDataset(str(manifest), Statistics(**STATS))
    with pytest.raises(IOError):
        list(stream.batches(1, seed=0))


def test_abandoned_epoch_retires_the_producer(manifest):
    """Leaving batches() after one batch must retire the producer thread
    (stop_event, drain, join), not leave it on a full queue."""
    csv_path, _ = manifest
    stream = StreamingModisDataset(csv_path, Statistics(**STATS), prefetch=1)
    before = threading.active_count()
    for _ in range(3):
        for batch in stream.batches(1, seed=0):
            assert batch["lst"].shape == (1, 64, 64, 1)
            break
    deadline = time.perf_counter() + 10.0
    while threading.active_count() > before and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
