"""The JAX package's reader checks, held on the port's readers.

``tests/test_hdf4_fixtures.py``, ``tests/test_hdf4.py`` and
``tests/test_geo_tiff.py`` check ``sifsr_tpu.geo``'s HDF4 and GeoTIFF
readers on byte-level fixtures, round trips and corrupt files. Here every
one of their cases (but the two that read reference rasters absent from the
repository), with its own parametrisation, runs the same bytes through
``sifsr_tpu.geo`` and ``sifsr_tpu_torch.geo``, which must give the same
outcome: equal arrays, dtypes, geotransforms, EPSG codes and metadata, or
the same exception. An HDF4 failure must be one of the typed errors that
``tests/test_hdf4.py::_expect_clean`` accepts.

- HDF4: each case runs as it is (on the JAX reader); then every ``.hdf``
  file it wrote goes through both packages.
- GeoTIFF: each case runs with its ``read_geotiff`` standing for both
  readers: each call reads the file with both, and the case's own checks
  run on what the port's reader returned or raised.

Then one seeded mutation-parity test for each reader: the flips,
truncations and 4-byte splices of ``tools/fuzz_hdf4.py`` and
``tools/fuzz_geotiff.py`` on their seed files. Both readers give the same
outcome on every mutant, no call takes longer than the fuzzers' 2 s guard,
and no HDF4 array passes their 256 MB allocation bound.
"""

import itertools
import os
import random
import struct
import time

import numpy as np
import pytest

from sifsr_tpu.geo import hdf4 as jax_hdf4
from sifsr_tpu.geo import tiff as jax_tiff

from sifsr_tpu_torch.geo import hdf4, tiff
from tests import test_geo_tiff, test_hdf4, test_hdf4_fixtures

SLOW_S = 2.0                 # the fuzzers' guard on one file's reads
MAX_ARRAY_BYTES = 1 << 28    # tools/fuzz_hdf4.py's allocation bound
N_MUTANTS = 400
REFERENCE_CASES = ("test_read_reference_aster_tiff", "test_read_all_reference_tiffs_headers")


def _cases(*modules):
    """Every test function of ``modules`` but the reference cases, once for
    each combination of its own ``parametrize`` marks: pytest params of
    (function, keyword arguments)."""
    out = []
    for mod in modules:
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or name in REFERENCE_CASES:
                continue
            axes = []
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    names = [n.strip() for n in mark.args[0].split(",")]
                    axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                                 for v in mark.args[1]])
            for combo in itertools.product(*axes):
                kwargs = {k: v for part in combo for k, v in part.items()}
                label = "-".join(str(v).replace(" ", "") for v in kwargs.values())
                out.append(pytest.param(fn, kwargs, id=f"{mod.__name__.split('.')[-1]}::{name}"
                                        + (f"[{label}]" if label else "")))
    return out


def _run_case(fn, kwargs, tmp_path, rng):
    fixtures = {"tmp_path": tmp_path, "rng": rng}
    fn(**{p: fixtures[p] for p in fn.__code__.co_varnames[:fn.__code__.co_argcount]
          if p in fixtures}, **kwargs)


def _outcome(call):
    """("ok", value) or ("error", exception)."""
    try:
        return "ok", call()
    except Exception as e:  # noqa: BLE001 — the exception is the outcome compared
        return "error", e


def _assert_same_value(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_value(g, w, f"{what}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), what
    else:
        assert got == want, what


def _hdf4_reads(mod, path):
    """Every read the JAX reader checks make, by one package, on one file:
    [(what, outcome)]. Stops at a file that does not open."""
    opened = _outcome(lambda: mod.HDF4File(path))
    reads = [("HDF4File", opened if opened[0] == "error" else ("ok", None))]
    if opened[0] == "ok":
        f = opened[1]
        reads.append(("dds", ("ok", f.dds)))
        names = _outcome(f.sds_names)
        reads.append(("sds_names", names))
        for name in (names[1] if names[0] == "ok" else []):
            for dtype in (None, np.float32, np.uint8):
                reads.append((f"read_sds({name!r}, {dtype})",
                              _outcome(lambda: f.read_sds(name, dtype=dtype))))
        reads += [("read_sds('nope')", _outcome(lambda: f.read_sds("nope"))),
                  ("grid_geotransform", _outcome(f.grid_geotransform)),
                  ("StructMetadata.0", _outcome(lambda: f.text_attribute("StructMetadata.0")))]
    reads += [("read_modis_lst day", _outcome(lambda: mod.read_modis_lst(path, "day", True))),
              ("read_modis_lst night", _outcome(lambda: mod.read_modis_lst(path, "night"))),
              ("read_modis_nir_red", _outcome(lambda: mod.read_modis_nir_red(path))),
              ("read_mod44w", _outcome(lambda: mod.read_mod44w(path)))]
    return reads


def _same_hdf4_error(got, want) -> bool:
    """The same type and message; or, where the JAX reader lets struct's or
    numpy's error out of a malformed Vgroup or Vdata, the port's HDF4Error
    at the same read (``HDF4Error``'s contract: never a bare
    ``struct.error``)."""
    if (type(got).__name__, str(got)) == (type(want).__name__, str(want)):
        return True
    return type(got) is hdf4.HDF4Error and type(want) in (struct.error, ValueError)


def _assert_same_hdf4(path) -> str:
    """Both packages read ``path`` alike, each within the fuzzer's guards;
    returns the outcome of opening it and reading its SDSs ("read" or the
    error's type)."""
    reads = {}
    for name, mod in (("jax", jax_hdf4), ("port", hdf4)):
        t = time.monotonic()
        reads[name] = _hdf4_reads(mod, str(path))
        assert time.monotonic() - t < SLOW_S, (name, path)
    assert [w for w, _ in reads["port"]] == [w for w, _ in reads["jax"]], path
    first_error = "read"
    for (what, (kind, got)), (_, (want_kind, want)) in zip(reads["port"], reads["jax"]):
        label = f"{os.path.basename(path)}: {what}"
        assert kind == want_kind, (label, got, want)
        if kind == "error":
            assert isinstance(got, (hdf4.HDF4Error, KeyError, NotImplementedError)), (label, got)
            assert _same_hdf4_error(got, want), (label, got, want)
            if first_error == "read" and what.startswith(("HDF4File", "sds_names", "read_sds(")) \
                    and what != "read_sds('nope')":
                first_error = type(got).__name__
        else:
            for a in (got if isinstance(got, tuple) else (got,)):
                assert not isinstance(a, np.ndarray) or a.nbytes < MAX_ARRAY_BYTES, label
            _assert_same_value(got, want, label)
    return first_error


def _read_geotiff_twin(path, problems: list):
    """``read_geotiff`` by both packages on the same file; returns the
    port's GeoTiff or raises the port's exception. A difference between the
    two outcomes, a call past the fuzzer's guard or an array past its bound
    is appended to ``problems``, not raised: a case's ``pytest.raises
    (Exception)`` would take an AssertionError for the reader's failure."""
    outcomes = {}
    try:
        for name, mod in (("jax", jax_tiff), ("port", tiff)):
            t = time.monotonic()
            outcomes[name] = _outcome(lambda: mod.read_geotiff(str(path)))
            assert time.monotonic() - t < SLOW_S, f"{name} past {SLOW_S} s"
        (kind, got), (want_kind, want) = outcomes["port"], outcomes["jax"]
        assert kind == want_kind, (got, want)
        if kind == "error":
            assert (type(got), str(got)) == (type(want), str(want))
        else:
            assert got.array.nbytes < MAX_ARRAY_BYTES, got.array.nbytes
            for field in ("array", "geotransform", "geo_keys", "geo_ascii", "geo_doubles",
                          "nodata"):
                _assert_same_value(getattr(got, field), getattr(want, field), field)
            assert got.epsg() == want.epsg(), "epsg"
    except AssertionError as e:
        problems.append(f"{path}: {e}")
    kind, got = outcomes["port"]
    if kind == "error":
        raise got
    return got


@pytest.mark.parametrize("case,kwargs", _cases(test_hdf4_fixtures, test_hdf4))
def test_hdf4_case_same_outcome(tmp_path, rng, case, kwargs):
    _run_case(case, kwargs, tmp_path, rng)
    files = sorted(tmp_path.glob("*.hdf"))
    assert files, "the case wrote no HDF4 file"
    for path in files:
        _assert_same_hdf4(path)


@pytest.mark.parametrize("case,kwargs", _cases(test_geo_tiff))
def test_geotiff_case_same_outcome(tmp_path, rng, monkeypatch, case, kwargs):
    calls, problems = [], []

    def twin(path):
        calls.append(path)
        return _read_geotiff_twin(path, problems)

    monkeypatch.setattr(test_geo_tiff, "read_geotiff", twin)
    _run_case(case, kwargs, tmp_path, rng)
    assert calls, "the case read no GeoTIFF"
    assert not problems, problems


def test_cases_cover_the_jax_reader_checks():
    """Every test of the three JAX files but the reference ones is a case,
    the tiled TIFF once for each of its 2 x 2 parametrisations."""
    want = {n for mod in (test_hdf4_fixtures, test_hdf4, test_geo_tiff) for n in vars(mod)
            if n.startswith("test_")} - set(REFERENCE_CASES)
    cases = _cases(test_hdf4_fixtures, test_hdf4) + _cases(test_geo_tiff)
    assert {p.values[0].__name__ for p in cases} == want
    assert len(want) == 29 and len(cases) == 32


def _vgroup_class_beyond_end(tmp_path):
    """A valid file whose Vgroup name runs to the element's end, so that its
    class-name length lies beyond it."""
    path = test_hdf4._valid_file(tmp_path)
    off, length = next(v for (t, _), v in jax_hdf4.HDF4File(path).dds.items()
                       if t == jax_hdf4.TAG_VG)
    data = bytearray(open(path, "rb").read())
    at = off + 2 + 4 * struct.unpack(">H", data[off:off + 2])[0]
    data[at:at + 2] = struct.pack(">H", length)
    return bytes(data)


def _vdata_order_beyond_field(tmp_path):
    """StructMetadata.0 whose one field declares 8 more values than its
    record holds."""
    text = b"GROUP=GridStructure\nEND\n"
    b = test_hdf4_fixtures.Builder()
    test_hdf4_fixtures.sds_scaffold(b, "LST_Day_1km", (4, 4))
    b.add(test_hdf4_fixtures.DFTAG_SD, 30, np.zeros((4, 4), ">i2").tobytes())
    b.add(test_hdf4_fixtures.DFTAG_VH, 160, test_hdf4_fixtures.vdata_header(
        "StructMetadata.0", [("VALUES", 3, len(text), len(text) + 8)], 1))
    b.add(test_hdf4_fixtures.DFTAG_VS, 160, text)
    return b.build()


@pytest.mark.parametrize("build,where", [(_vgroup_class_beyond_end, "sds_names"),
                                         (_vdata_order_beyond_field, "grid_geotransform")])
def test_malformed_vgroup_and_vdata_raise_hdf4error(tmp_path, build, where):
    """Two malformed elements that the JAX reader lets out as struct's or
    numpy's error (the seeded HDF4 mutants below hold one of each kind):
    the port raises HDF4Error at the same read, and reads the rest alike."""
    path = tmp_path / "malformed.hdf"
    path.write_bytes(build(tmp_path))
    with pytest.raises((struct.error, ValueError)) as leaked:
        getattr(jax_hdf4.HDF4File(str(path)), where)()
    assert type(leaked.value) is not jax_hdf4.HDF4Error
    with pytest.raises(hdf4.HDF4Error):
        getattr(hdf4.HDF4File(str(path)), where)()
    _assert_same_hdf4(path)


def _mutants(seeds, rng: random.Random, n: int):
    """The fuzzers' mutants: bit flips, a truncation, a 4-byte splice, in
    turn (tools/fuzz_hdf4.py, tools/fuzz_geotiff.py)."""
    for it in range(n):
        d = bytearray(rng.choice(seeds))
        kind = it % 3
        if kind == 0:
            for _ in range(rng.randint(1, 8)):
                d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
        elif kind == 1:
            d = d[:rng.randrange(len(d))]
        else:
            at = rng.randrange(max(1, len(d) - 4))
            d[at:at + 4] = rng.randbytes(4)
        yield bytes(d)


def test_hdf4_mutants_same_outcome(tmp_path):
    """tools/fuzz_hdf4.py's seeds (its writer, its seeded arrays, with and
    without deflate) and mutations: the same outcome from both readers."""
    rng = np.random.default_rng(11)
    seeds = []
    for i, deflate in enumerate((False, True)):
        p = str(tmp_path / f"seed{i}.hdf")
        jax_hdf4.write_hdf4_sds(p, {
            "LST_Day_1km": (rng.random((32, 32)) * 30000).astype(np.int16),
            "QC_Day": rng.integers(0, 255, (32, 32)).astype(np.uint8),
        }, struct_metadata="GROUP=GridStructure\nEND\n", deflate=deflate)
        seeds.append(open(p, "rb").read())
    path = tmp_path / "mutant.hdf"
    seen = {}
    for data in _mutants(seeds, random.Random(11), N_MUTANTS):
        path.write_bytes(data)
        first = _assert_same_hdf4(path)
        seen[first] = seen.get(first, 0) + 1
    assert seen.get("read", 0) > 0 and seen.get("HDF4Error", 0) > 0, seen


def test_geotiff_mutants_same_outcome(tmp_path):
    """tools/fuzz_geotiff.py's seeds (float32 and int16 strips from the
    writer) and mutations: the same outcome from both readers."""
    rng = np.random.default_rng(5)
    seeds = []
    for i, arr in enumerate((rng.normal(size=(32, 48)).astype(np.float32),
                             rng.integers(0, 30000, (24, 24)).astype(np.int16))):
        p = str(tmp_path / f"seed{i}.tif")
        jax_tiff.write_geotiff(p, arr)
        seeds.append(open(p, "rb").read())
    path = tmp_path / "mutant.tif"
    seen, problems = {}, []
    for data in _mutants(seeds, random.Random(5), N_MUTANTS):
        path.write_bytes(data)
        outcome = _outcome(lambda: _read_geotiff_twin(path, problems))
        key = "read" if outcome[0] == "ok" else type(outcome[1]).__name__
        seen[key] = seen.get(key, 0) + 1
    assert not problems, problems
    assert seen.get("read", 0) > 0 and len(seen) > 1, seen
