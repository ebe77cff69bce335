"""The port's ``cli.compare_methods`` against the JAX package's, every
subcommand on the same synthetic results tree (tests/test_compare_methods_cli.py's
fixtures): the same files, the same printed statistics and the same CSVs,
the spectral scores within 1e-6 relative (JAX scores float32 spectra in
float32, the port in float64)."""

import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest

from sifsr_tpu.cli import compare_methods as jax_cm

from sifsr_tpu_torch.cli import compare_methods as cm
from sifsr_tpu_torch.geo.tiff import write_geotiff

SPECTRAL = ["PFR", "AFR", "FRR", "FRO", "FRU"]


def _results(root, rng, n_pairs=3, models=cm.MODELS7):
    """dict_pred pickles of every method for n_pairs pairs (float64 crops,
    as the harness pickles them) and a performances.csv per method."""
    results = root / "results"
    yy, xx = np.meshgrid(np.arange(96), np.arange(96), indexing="ij")
    for idx in range(n_pairs):
        aster = 300 + np.sin(yy / 2.5) * np.cos(xx / 3.1) + 0.2 * rng.normal(size=(96, 96))
        base = {"LST:": 300 + 0.5 * np.sin(yy / 2.5) * np.cos(xx / 3.1) + rng.normal() * 0.3,
                "NDVI": 0.5 + 0.1 * np.sin(xx / 4.0), "LST_ASTER": aster}
        for k, method in enumerate(models):
            d = results / method
            d.mkdir(parents=True, exist_ok=True)
            pred = (300 + (0.5 + 0.07 * k) * np.sin(yy / 2.5) * np.cos(xx / 3.1)
                    + 0.05 * rng.normal(size=(96, 96)))
            with open(d / f"{idx}_dict_pred.pkl", "wb") as f:
                pickle.dump({**base, "LST_SR": pred}, f)
    for method in models:
        perf = pd.DataFrame(
            {"PSNR": 20 + rng.random(n_pairs), "SSIM": 0.5 + 0.1 * rng.random(n_pairs),
             "RMSE": 1.5 + rng.random(n_pairs), "GSSIM": 0.3 + 0.1 * rng.random(n_pairs),
             "LPIPS": np.nan}, index=range(n_pairs))
        perf.loc["mean"] = perf.mean()
        perf.loc["std"] = perf.std()
        perf.to_csv(results / method / "performances.csv")
    return results


def _assert_scores_close(got, want):
    """Each pair's scores and their mean within 1e-6 relative; their std,
    a difference of nearby values, within 1e-6 of the largest score."""
    rows = [i for i in want.index if i != "std"]
    np.testing.assert_allclose(got.loc[rows, SPECTRAL].to_numpy(float),
                               want.loc[rows, SPECTRAL].to_numpy(float), rtol=1e-6, atol=0)
    scale = np.nanmax(np.abs(want.loc[rows, SPECTRAL].to_numpy(float)), axis=0)
    d = np.abs(got.loc["std", SPECTRAL].to_numpy(float) - want.loc["std", SPECTRAL].to_numpy(float))
    assert (d <= 1e-6 * scale).all(), (d, scale)


@pytest.fixture()
def trees(tmp_path, rng):
    """The same results tree twice: one for each package."""
    ref = _results(tmp_path / "jax", rng)
    port = tmp_path / "port" / "results"
    shutil.copytree(ref, port)
    return ref, port


def _run(capsys, main, argv, ref_dir, port_dir):
    """Run the JAX main on ref_dir's argv and the port's on port_dir's;
    the two printouts with the directories named alike."""
    main[0](argv(ref_dir))
    want = capsys.readouterr()
    main[1](argv(port_dir))
    got = capsys.readouterr()
    norm = lambda s, d: s.replace(str(d), "<root>")  # noqa: E731
    return (norm(got.out, port_dir), norm(got.err, port_dir),
            norm(want.out, ref_dir), norm(want.err, ref_dir))


@pytest.mark.parametrize("legacy", [False, True], ids=["subcommand", "flag-only"])
def test_spectra_matches_jax(trees, capsys, legacy):
    ref, port = trees
    models = ["TsHARP", "DMS", "modelB_1009"]

    def argv(d):
        head = [] if legacy else ["spectra"]
        return head + ["--results-dir", str(d), "--models", *models,
                       "--figure", str(d / "spectrum.png")]

    jax_cm.main(argv(ref))
    want_out = capsys.readouterr().out
    cm.main(argv(port) + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    for m in models:
        got = pd.read_csv(port / m / "performances.csv", index_col=0)
        want = pd.read_csv(ref / m / "performances.csv", index_col=0)
        assert list(got.columns) == list(want.columns) and list(got.index) == list(want.index)
        other = [c for c in want.columns if c not in SPECTRAL]
        pd.testing.assert_frame_equal(got[other], want[other])
        _assert_scores_close(got, want)
        assert np.isfinite(got[SPECTRAL].to_numpy()[:3]).all()
    assert (port / "spectrum.png").exists() and (ref / "spectrum.png").exists()
    # the summary lines, rounded to 3 decimals, read alike
    assert ([l for l in got_out.splitlines() if "=" in l]
            == [l for l in want_out.splitlines() if "=" in l])


def test_spectra_scores_skip_what_jax_skips(tmp_path, rng, capsys):
    """A model without a pair's pickle, or with a crop of another shape, is
    not scored on that pair, as in JAX."""
    ref = _results(tmp_path / "jax", rng, models=["bicubic", "m"])
    os.remove(ref / "m" / "1_dict_pred.pkl")
    with open(ref / "m" / "2_dict_pred.pkl", "rb") as f:
        d = pickle.load(f)
    with open(ref / "m" / "2_dict_pred.pkl", "wb") as f:
        pickle.dump({**d, "LST_SR": d["LST_SR"][:90]}, f)
    port = tmp_path / "port" / "results"
    shutil.copytree(ref, port)
    jax_cm.main(["spectra", "--results-dir", str(ref), "--models", "m"])
    cm.main(["spectra", "--results-dir", str(port), "--models", "m", "--device", "cpu"])
    got = pd.read_csv(port / "m" / "performances.csv", index_col=0)
    want = pd.read_csv(ref / "m" / "performances.csv", index_col=0)
    _assert_scores_close(got, want)
    assert np.isnan(got.loc["1", "FRR"]) and np.isfinite(got.loc["0", "FRR"])


def test_figures_and_contrast_match_jax(trees, capsys):
    ref, port = trees
    for argv in (lambda d: ["figures", "--results-dir", str(d), "--out", str(d / "figs"),
                            "--limit", "1"],
                 lambda d: ["contrast", "--results-dir", str(d), "--index", "1",
                            "--out", str(d / "contrast.png")]):
        got, _, want, _ = _run(capsys, (jax_cm.main, cm.main), argv, ref, port)
        assert got == want
    assert sorted(os.listdir(port / "figs")) == sorted(os.listdir(ref / "figs"))
    assert len(os.listdir(port / "figs")) == 4
    assert (port / "contrast.png").exists()


def test_scatters_match_jax(trees, capsys):
    ref, port = trees
    got, _, want, _ = _run(capsys, (jax_cm.main, cm.main),
                           lambda d: ["scatters", "--results-dir", str(d), "--model",
                                      "modelB_1009", "--out", str(d / "figs")], ref, port)
    assert got == want and "correlation of |bias_1km| with:" in got
    assert sorted(os.listdir(port / "figs")) == sorted(os.listdir(ref / "figs"))


@pytest.mark.parametrize("with_time_column", [False, True])
def test_seasons_match_jax(tmp_path, capsys, with_time_column):
    rows = []
    for day, split, tod in [(30, "Train", "day"), (100, "Train", "day"), (200, "Train", "day"),
                            (300, "Train", "day"), (340, "Train", "day"), (100, "Val", "day"),
                            (210, "Train", "night")]:
        lst_dir = "data/geotiff/LST" if with_time_column else f"data/lst_{tod}"
        rows.append({"LST": f"{lst_dir}/MOD21A1D.A2020{day:03d}.h18v04.061.12.tif",
                     "NDVI": f"data/ndvi/MOD09GQ.A2020{day:03d}.h18v04.061.12.tif",
                     "split": split, **({"time": "D"} if with_time_column else {})})
    csv = tmp_path / "ModisDatasetB.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    got, got_err, want, want_err = _run(
        capsys, (jax_cm.main, cm.main),
        lambda d: ["seasons", "--dataset-csv", str(csv), "--out", str(d / "seasons.png")],
        tmp_path / "a", tmp_path / "b")
    assert got == want and got_err == want_err
    assert "season counts:" in got and (tmp_path / "b" / "seasons.png").exists()


def test_regression_matches_jax(tmp_path, capsys, rng):
    from sifsr_tpu_torch.data.statistics import Statistics

    stats = Statistics(maxi=330.0, mini=260.0, mean_lst=295.0, std_lst=10.0,
                       mean_ndvi=0.3, std_ndvi=0.25)
    stats_json = tmp_path / "statistics.json"
    stats.to_json(str(stats_json))
    (tmp_path / "pairs").mkdir()
    rows = []
    for i in range(3):
        ndvi = (0.3 + 0.2 * rng.random((256, 256))).astype(np.float32)
        lst = (300.0 - 20.0 * ndvi[::4, ::4] + 0.05 * rng.normal(size=(64, 64))).astype(np.float32)
        lst_p = tmp_path / "pairs" / f"MOD21A1D_day.A2020{100 + i:03d}.{i}.tif"
        ndvi_p = tmp_path / "pairs" / f"MOD09GQ.A2020{100 + i:03d}.{i}.tif"
        write_geotiff(str(lst_p), lst)
        write_geotiff(str(ndvi_p), ndvi)
        rows.append({"LST": str(lst_p), "NDVI": str(ndvi_p), "split": "Train"})
    csv = tmp_path / "ModisDatasetB.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    got, _, want, _ = _run(capsys, (jax_cm.main, cm.main),
                           lambda d: ["regression", "--dataset-csv", str(csv), "--statistics",
                                      str(stats_json), "--out", str(d / "reg.png")],
                           tmp_path / "a", tmp_path / "b")
    assert got == want and "Average Regression Parameters" in got
    assert (tmp_path / "b" / "reg.png").exists()


@pytest.mark.parametrize("source", ["csv", "synthetic", "performances"])
def test_timediff_matches_jax(tmp_path, capsys, source):
    df = pd.DataFrame({**{f"c{i}": np.arange(6) for i in range(8)},
                       "timediff_h": [0.25, -0.5, 0.1, 1.0, 0.3, -0.2]}, index=range(6))
    csv = tmp_path / "aster_modis_dataset_2.csv"
    df.to_csv(csv)
    perf = pd.DataFrame({"PSNR": [20.0, 21.0, 22.0]}, index=[0, 2, 4])
    perf.to_csv(tmp_path / "performances.csv")
    argv = {"csv": ["--test-data-csv", str(csv)],
            "synthetic": ["--synthetic", "40", "--seed", "3"],
            "performances": ["--test-data-csv", str(csv), "--performances",
                             str(tmp_path / "performances.csv")]}[source]
    jax_cm.main(["timediff", *argv])
    want = capsys.readouterr().out
    cm.main(["timediff", *argv])
    got = capsys.readouterr().out
    assert got == want and "Mean:" in got
