"""The port's data-preparation tooling against the JAX package's on the same
seeded files: ``cli.process_modis`` (HDF4 granules -> patch GeoTIFFs and the
pairs CSV), ``cli.data_preparation`` (the reference's split RNG stream and
the statistics JSON), ``data.statistics.compute_statistics`` and
``cli.download``'s plan (no fetch). Every output is equal to JAX's."""

import dataclasses
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest

from sifsr_tpu.cli import data_preparation as jax_prep
from sifsr_tpu.cli import download as jax_download
from sifsr_tpu.cli import process_modis as jax_process
from sifsr_tpu.data.statistics import compute_statistics as jax_compute_statistics

from sifsr_tpu_torch.cli import data_preparation, download, process_modis
from sifsr_tpu_torch.data import compute_statistics
from sifsr_tpu_torch.geo.hdf4 import write_hdf4_sds
from sifsr_tpu_torch.geo.tiff import read_geotiff, write_geotiff


def _struct_meta(size: int, res: float) -> str:
    return ("GROUP=GridStructure\n"
            f"\tXDim={size}\n\tYDim={size}\n"
            "\tUpperLeftPointMtrs=(0.000000,5559752.598333)\n"
            f"\tLowerRightMtrs=({size * res:.6f},{5559752.598333 - size * res:.6f})\n"
            "END_GROUP=GridStructure\n")


def _granules(root, rng, product, n_days=2, size=192):
    """MOD21A1D / MOD11A1-like LST granules (DN x 0.02 K, a QC SDS with some
    bad pixels, a 0 fill corner) and their MOD09GQ-like pairs, one a day;
    one LST day without a reflectance granule."""
    lst_dir, nir_dir = root / "hdf" / f"{product}.061", root / "hdf" / "MOD09GQ.061"
    lst_dir.mkdir(parents=True)
    nir_dir.mkdir(parents=True)
    for day in range(n_days + 1):
        date = f"2017{100 + day:03d}"
        lst_dn = (rng.random((size, size)) * 1500 + 14500).astype(np.uint16)
        lst_dn[:40, :40] = 0
        qc = np.zeros((size, size), np.uint8)
        qc[rng.random((size, size)) < 0.002] = 0b11
        write_hdf4_sds(str(lst_dir / f"{product}.A{date}.h18v04.061.hdf"),
                       {"LST_Day_1KM": lst_dn, "QC_Day": qc},
                       struct_metadata=_struct_meta(size, 926.625433), deflate=True)
        if day == n_days:
            continue
        base = rng.random((4 * size, 4 * size)) * 0.3 + 0.2
        red = (base * 10000).astype(np.int16)
        nir = ((base + 0.3) * 10000).astype(np.int16)
        red[:8, 300:308] = nir[:8, 300:308] = 0  # zero NIR+Red denominators
        write_hdf4_sds(str(nir_dir / f"MOD09GQ.A{date}.h18v04.061.hdf"),
                       {"sur_refl_b01_1": red, "sur_refl_b02_1": nir},
                       struct_metadata=_struct_meta(4 * size, 231.656358), deflate=True)
    return str(lst_dir), str(nir_dir)


@pytest.mark.parametrize("product,coverage,workers", [("MOD21A1D", 0.0, 1),
                                                      ("MOD11A1", 0.5, 2)])
def test_process_modis_equal_jax(tmp_path, rng, monkeypatch, product, coverage, workers):
    lst_dir, nir_dir = _granules(tmp_path, rng, product)
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main in (("jax", jax_process.main), ("port", process_modis.main)):
        main(["--product", product, "--coverage", str(coverage), "--workers", str(workers),
              "--lst-dir", lst_dir, "--nirred-dir", nir_dir,
              "--out-lst", f"{name}/LST", "--out-ndvi", f"{name}/NDVI",
              "--pairs-out", f"{name}/pairs_day.csv"])
        out[name] = pd.read_csv(f"{name}/pairs_day.csv", index_col=0)
        assert os.path.exists(f"{name}/pairs_day_error.png")
    got, want = out["port"], out["jax"]
    assert 0 < len(got) == len(want) < 2 * 9
    for col in ("LST", "NDVI"):
        assert [p.replace("port/", "", 1) for p in got[col]] == \
               [p.replace("jax/", "", 1) for p in want[col]]
        for g, w in zip(got[col], want[col]):
            a, b = read_geotiff(g), read_geotiff(w)
            np.testing.assert_array_equal(a.array, b.array)
            assert a.geotransform == b.geotransform


def test_process_modis_without_matplotlib(tmp_path, rng, monkeypatch):
    """Where matplotlib is missing (the card machine), both packages write
    the patches and the pairs CSV, then stop on the histogram's import."""
    lst_dir, nir_dir = _granules(tmp_path, rng, "MOD21A1D", n_days=1)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = {}
    for name, main in (("jax", jax_process.main), ("port", process_modis.main)):
        with pytest.raises(ImportError, match="matplotlib"):
            main(["--lst-dir", lst_dir, "--nirred-dir", nir_dir, "--out-lst", f"{name}/LST",
                  "--out-ndvi", f"{name}/NDVI", "--pairs-out", f"{name}/pairs_day.csv"])
        out[name] = pd.read_csv(f"{name}/pairs_day.csv", index_col=0)
        assert len(out[name]) > 0 and all(os.path.exists(p) for p in out[name]["LST"])
        assert not os.path.exists(f"{name}/pairs_day_error.png")
    assert [p.replace("port/", "", 1) for p in out["port"]["NDVI"]] == \
           [p.replace("jax/", "", 1) for p in out["jax"]["NDVI"]]


def _pairs_csv(tmp_path, rng, n=40):
    os.makedirs(tmp_path / "data" / "t", exist_ok=True)
    rows = []
    for i in range(n):
        lst_p, ndvi_p = f"data/t/lst_{i}.tiff", f"data/t/ndvi_{i}.tiff"
        write_geotiff(str(tmp_path / lst_p), (290 + 10 * rng.random((8, 8))).astype(np.float32))
        write_geotiff(str(tmp_path / ndvi_p), rng.random((32, 32)).astype(np.float32))
        rows.append((lst_p, ndvi_p))
    pd.DataFrame(rows, columns=("LST", "NDVI")).to_csv(tmp_path / "data" / "pairs_day.csv")


@pytest.mark.parametrize("extra", [[], ["--seed", "7", "--train-fraction", "0.7"]])
def test_data_preparation_equal_jax(tmp_path, rng, monkeypatch, capsys, extra):
    """The same split (the reference's random.seed/choices stream and the
    pandas shuffle), manifest and statistics JSON as JAX's, byte for byte."""
    _pairs_csv(tmp_path, rng)
    monkeypatch.chdir(tmp_path)
    printed = {}
    for name, main in (("jax", jax_prep.main), ("port", data_preparation.main)):
        main(["--pairs", "data/pairs_day.csv", "--out", f"{name}/ModisDatasetB.csv",
              "--statistics-out", f"{name}/statistics.json", *extra])
        printed[name] = capsys.readouterr().out.replace(f"{name}/", "")
    assert printed["port"] == printed["jax"]
    for f in ("ModisDatasetB.csv", "statistics.json"):
        with open(f"port/{f}") as a, open(f"jax/{f}") as b:
            assert a.read() == b.read(), f
    stats = json.load(open("port/statistics.json"))
    assert set(stats) == {"maxi", "mini", "mean_lst", "std_lst", "mean_ndvi", "std_ndvi"}


def test_compute_statistics_equal_jax(rng):
    lst = [rng.normal(300 - 10 * k, 2, size=(64, 64)).astype(np.float32) for k in range(3)]
    ndvi = [rng.random((256, 256)) for _ in range(3)]
    got = compute_statistics(iter(lst), iter(ndvi))
    want = jax_compute_statistics(iter(lst), iter(ndvi))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("start,stop,n", [("2020-01-01", "2020-01-31", 4),
                                          ("2020-01-01", "2020-01-31", 7),
                                          ("2020-02-27", "2020-03-02", 2),
                                          ("2020-01-01", "2020-01-01", 3),
                                          ("2017-01-01", "2019-12-31", 12)])
def test_download_plan_equal_jax(tmp_path, start, stop, n):
    assert download.date_chunks(start, stop, n) == jax_download.date_chunks(start, stop, n)
    assert download.PRODUCTS == jax_download.PRODUCTS
    args = (list(download.PRODUCTS), start, stop, n, str(tmp_path), "h18v04")
    assert download.fetch_plan(*args) == jax_download.fetch_plan(*args)


def test_download_dry_run_and_refusals_equal_jax(capsys):
    argv = ["--start_date", "2020-01-01", "--stop_date", "2020-01-08", "--n_threads", "4",
            "--dry-run"]
    jax_download.main(argv)
    want = capsys.readouterr().out
    download.main(argv)
    assert capsys.readouterr().out == want and "dry-run: 20 download jobs" in want
    for bad in (["--start_date", "2020-01-02", "--stop_date", "2020-01-01", "--dry-run"],
                ["--start_date", "2020-01-01", "--stop_date", "2020-01-02"]):
        with pytest.raises(SystemExit):
            jax_download.main(bad)
        want = capsys.readouterr().err
        with pytest.raises(SystemExit):
            download.main(bad)
        assert capsys.readouterr().err == want
