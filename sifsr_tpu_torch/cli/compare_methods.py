"""Cross-method analysis & figure factory (reference compare_methods.py rebuilt).

The reference is a cell-notebook script; here each analysis family is a
subcommand over the results tree produced by ``model_perf --save-pairs``:

    spectra     Fourier attenuation spectra + PFR/AFR/FRR/FRO/FRU appended to
                performances.csv + average-spectrum figure (reference :275-583)
    figures     per-pair 7-method figure sets: comparison grid, temperature /
                HF distribution box+violins, hexbin regressions vs ASTER,
                per-pair attenuation spectra (reference :586-858)
    scatters    metric-vs-1km-bias / 1km-RMSE scatter plots (reference
                :167-272 — the 1 km bias/RMSE are computed here from the
                formatted crops' NN-upsampled LST vs ASTER, since the
                unformatted test_data with precomputed bias csv isn't shipped)
    seasons     training-data season histogram (reference :39-76, including
                its exact strict-inequality season buckets)
    regression  LST-NDVI linear-regression study over dataset items with the
                3x3 hexbin panel (reference :78-137)
    timediff    ASTER-MODIS acquisition time-difference statistics
                (reference :139-165; needs the unformatted test_data csv
                with the time column — pass --test-data-csv)
    contrast    contrast-inversion case study: ASTER vs SIF-NN-SR1 vs DMS
                (reference :860-895)

Legacy flag-only invocation (no subcommand) keeps the `spectra` behavior.

Port of ``sifsr_tpu/cli/compare_methods.py``, same subcommands, flags and
outputs. ``spectra`` takes ``--device`` (default ``cuda``): each pair's
spectra (ASTER, bicubic and every model's crop, one batch) and the five
scores run on the device through ``eval.spectra``: the transform of the
float64 crops in float64, the scores in float64 on the float32 spectra.
The figures need matplotlib, imported only where a figure is drawn
(``spectra --figure``, ``figures``, ``scatters``, ``seasons``,
``regression``, ``contrast``): ``spectra`` without ``--figure`` and
``timediff`` run without it.
"""

from __future__ import annotations

import glob
import os
import pickle
import sys
from argparse import ArgumentParser

import numpy as np
import torch

MODELS7 = ["bicubic", "TsHARP", "ATPRK", "DMS", "modelB_2011", "modelB_1009", "modelB_2609"]
LABELS7 = ["bicubic", "TsHARP", "ATPRK", "DMS", "SC-Unet", "SIF-NN-SR1", "SIF-NN-SR2"]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _indices(results_dir: str, model: str = "bicubic") -> list[str]:
    pkls = sorted(glob.glob(os.path.join(results_dir, model, "*_dict_pred.pkl")))
    return [os.path.basename(p).split("_")[0] for p in pkls]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _hf(x: np.ndarray) -> np.ndarray:
    """x - PSF lowpass (get_output_ftm defaults factor=4 mtf=0.1), via the
    per-axis matrix chain (same construction as eval/harness.py)."""
    from sifsr_tpu_torch.ops.psf import lowpass_matrix

    m1 = lowpass_matrix(x.shape[0], 4, 0.1)
    m2 = lowpass_matrix(x.shape[1], 4, 0.1)
    return x - m1 @ x @ m2.T


# ------------------------------------------------------------------ spectra

def cmd_spectra(argv):
    parser = ArgumentParser(prog="compare_methods spectra")
    parser.add_argument("--dataset", default="./test_data_formatted")
    parser.add_argument("--models", nargs="+", required=True,
                        help="results subdirectories to score (bicubic is implicit)")
    parser.add_argument("--figure", default=None, help="average-spectrum PNG path")
    parser.add_argument("--results-dir", default=None,
                        help="override <dataset>/results as the results root")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or 'cpu'")
    args = parser.parse_args(argv)

    from sifsr_tpu_torch.device import resolve_device
    from sifsr_tpu_torch.eval.spectra import afr, attenuation_spectrum, frr, fro, fru, pfr

    device = resolve_device(args.device)

    results_dir = args.results_dir or os.path.join(args.dataset, "results")
    bicubic_pkls = sorted(glob.glob(os.path.join(results_dir, "bicubic", "*_dict_pred.pkl")))
    if not bicubic_pkls:
        parser.error(f"no bicubic dict_pred pkls under {results_dir}/bicubic "
                     "(run model_perf --sr-type bicubic --save-pairs first)")

    scores = {m: {k: [] for k in ("PFR", "AFR", "FRR", "FRO", "FRU")} for m in args.models}
    spectra_acc: dict[str, list] = {m: [] for m in ["ASTER", "bicubic", *args.models]}

    for bic_path in bicubic_pkls:
        idx = os.path.basename(bic_path).split("_")[0]
        bic = _load(bic_path)
        crops = {}
        for model in args.models:
            path = os.path.join(results_dir, model, f"{idx}_dict_pred.pkl")
            if not os.path.exists(path):
                continue
            crop = _load(path)["LST_SR"]
            if crop.shape == bic["LST_SR"].shape:
                crops[model] = crop
        # ASTER, bicubic and the models' crops of the pair: one batch
        images = np.stack([bic["LST_ASTER"], bic["LST_SR"], *crops.values()])
        spectra = attenuation_spectrum(torch.as_tensor(images, dtype=torch.float64,
                                                       device=device)).double()
        rb, xb = spectra[0], spectra[1]
        spectra_acc["ASTER"].append(spectra[0].cpu().numpy())
        spectra_acc["bicubic"].append(spectra[1].cpu().numpy())
        for model, pb in zip(crops, spectra[2:]):
            spectra_acc[model].append(pb.cpu().numpy())
            scores[model]["PFR"].append(float(pfr(rb, xb)))
            scores[model]["AFR"].append(float(afr(pb, rb, xb)))
            scores[model]["FRR"].append(float(frr(pb, rb, xb)))
            scores[model]["FRO"].append(float(fro(pb, rb, xb)))
            scores[model]["FRU"].append(float(fru(pb, rb, xb)))

    import pandas as pd

    for model in args.models:
        perf_path = os.path.join(results_dir, model, "performances.csv")
        summary = {k: (float(np.mean(v)), float(np.std(v))) for k, v in scores[model].items() if v}
        print(f"{model}: " + "  ".join(f"{k}={m:.3f}±{s:.3f}" for k, (m, s) in summary.items()))
        if os.path.exists(perf_path) and scores[model]["FRR"]:
            df = pd.read_csv(perf_path, index_col=0)
            for k, v in scores[model].items():
                col = np.full(len(df), np.nan)
                col[: len(v)] = v
                df[k] = col
                df.loc["mean", k] = np.mean(v)
                df.loc["std", k] = np.std(v)
            df.to_csv(perf_path)
            print(f"  appended spectral scores to {perf_path}")

    if args.figure:
        plt = _mpl()
        plt.figure(figsize=(10, 7))
        # interpolate every spectrum onto a common normalised-frequency grid
        # before averaging (compare_methods.py:492-524)
        grid = np.linspace(0, 1, 128)
        for name, specs in spectra_acc.items():
            if not specs:
                continue
            interp = [np.interp(grid, np.linspace(0, 1, len(s)), s) for s in specs]
            plt.plot(grid, np.mean(interp, axis=0), label=name)
        plt.xlabel("normalised spatial frequency")
        plt.ylabel("attenuation (dB re f0)")
        plt.legend()
        plt.savefig(args.figure, bbox_inches="tight")
        print(f"wrote {args.figure}")


# ------------------------------------------------------------------ figures

def cmd_figures(argv):
    """Per-pair 7-method figure sets (reference compare_methods.py:586-858)."""
    parser = ArgumentParser(prog="compare_methods figures")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--out", default="figures_test_dataset")
    parser.add_argument("--models", nargs=7, default=MODELS7,
                        help="7 results subdirectories (reference order)")
    parser.add_argument("--labels", nargs=7, default=LABELS7)
    parser.add_argument("--indices", nargs="*", default=None)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    from scipy import stats as sps

    from sifsr_tpu_torch.eval.spectra import attenuation_spectrum_np

    plt = _mpl()
    os.makedirs(args.out, exist_ok=True)
    indices = args.indices or _indices(args.results_dir)
    if args.limit:
        indices = indices[: args.limit]
    if not indices:
        parser.error(f"no dict_pred pkls under {args.results_dir}/bicubic")

    made = 0
    for idx in indices:
        paths = {m: os.path.join(args.results_dir, m, f"{idx}_dict_pred.pkl")
                 for m in args.models}
        if not all(os.path.exists(p) for p in paths.values()):
            print(f"pair {idx}: skipped (missing dict_pred for some method)")
            continue
        bic = _load(paths[args.models[0]])
        preds = {m: _load(p)["LST_SR"] for m, p in paths.items()}
        # per-method SR values shift the valid-footprint corner detection by
        # a pixel on some pairs — crop everything to the common min shape
        hmin = min(min(p.shape[0] for p in preds.values()), bic["LST_ASTER"].shape[0])
        wmin = min(min(p.shape[1] for p in preds.values()), bic["LST_ASTER"].shape[1])
        aster = bic["LST_ASTER"][:hmin, :wmin]
        bic = {**bic, "LST:": bic["LST:"][:hmin, :wmin], "NDVI": bic["NDVI"][:hmin, :wmin]}
        preds = {m: p[:hmin, :wmin] for m, p in preds.items()}
        mini, maxi = float(aster.min()), float(aster.max())

        # 1st figure: 3x3 comparison grid with a shared colorbar (:651-704)
        fig, axes = plt.subplots(3, 3, figsize=(10, 10))
        panels = [("LST", bic["LST:"]), ("LST ASTER", aster)] + [
            (f"LST SR {lab}", preds[m]) for m, lab in zip(args.models, args.labels)
        ]
        for ax, (title, img) in zip(axes.ravel(), panels):
            im = ax.imshow(img, cmap="jet", vmin=mini, vmax=maxi)
            ax.axis("off")
            ax.set_title(title, fontsize=9)
        fig.colorbar(im, cax=fig.add_axes([0.92, 0.15, 0.03, 0.7]))
        fig.savefig(os.path.join(args.out, f"{idx}_prediction_comparison_tds.png"),
                    dpi=90, bbox_inches="tight")
        plt.close(fig)

        # 2nd figure: temperature + HF-content box/violin distributions (:706-724)
        tdict = {"ASTER": aster.ravel(), **{m: preds[m].ravel() for m in args.models}}
        hdict = {"ASTER": _hf(aster).ravel(),
                 **{m: _hf(preds[m]).ravel() for m in args.models}}
        labels = ["ASTER", *args.labels]
        fig, ax = plt.subplots(1, 2, figsize=(23, 7))
        for panel, (dat, ylab) in zip(ax, [(tdict, "Temperature T (K)"),
                                           (hdict, "T - K * I (K)")]):
            panel.boxplot(list(dat.values()))
            panel.violinplot(list(dat.values()))
            panel.set_xticks(range(1, len(labels) + 1))
            panel.set_xticklabels(labels, fontsize=10)
            panel.set_ylabel(ylab, fontsize=14)
        fig.savefig(os.path.join(args.out, f"{idx}_prediction_distribution_tds.png"),
                    dpi=90, bbox_inches="tight")
        plt.close(fig)

        # 3rd figure: hexbin regression of each method vs ASTER, bicubic
        # excluded (:728-778)
        meths = args.models[1:]
        min_p = min(float(preds[m].min()) for m in meths)
        max_p = max(float(preds[m].max()) for m in meths)
        fig, ax = plt.subplots(2, 3, figsize=(16, 11))
        for i, m in enumerate(meths):
            a = ax[i // 3][i % 3]
            reg = sps.linregress(aster.ravel(), preds[m].ravel())
            hb = a.hexbin(aster.ravel(), preds[m].ravel(), gridsize=50, bins="log")
            fig.colorbar(hb, ax=a)
            a.plot([mini, maxi],
                   [reg.slope * mini + reg.intercept, reg.slope * maxi + reg.intercept],
                   color="red")
            a.grid()
            a.set_title(f"{args.labels[1 + i]}: LST_SR = {reg.slope:.2g} LST_ASTER "
                        f"{reg.intercept:+.2g}, R²={reg.rvalue ** 2:.2g}", fontsize=9)
            a.set_xlabel("ASTER Temperature (K)")
            a.set_ylabel("MODIS Downscaled Temperature (K)")
            a.set_xlim([mini, maxi])
            a.set_ylim([min_p - 1, max_p + 1])
        fig.savefig(os.path.join(args.out, f"{idx}_prediction_temperature_tds.png"),
                    dpi=90, bbox_inches="tight")
        plt.close(fig)

        # 4th figure: per-pair attenuation spectra incl. NDVI, physical
        # frequency axis Fe = 1/231.65 m (:782-858)
        spec = {"ASTER": attenuation_spectrum_np(aster),
                "NDVI": attenuation_spectrum_np(bic["NDVI"]),
                **{m: attenuation_spectrum_np(preds[m]) for m in args.models}}
        x_axis = np.linspace(1.0 / (231.65 * 2 * len(spec["ASTER"])), 1.0 / 231.65,
                             len(spec["ASTER"]))
        fig, ax = plt.subplots(1, figsize=(10, 7))
        for (name, s), lab in zip(spec.items(), ["ASTER", "NDVI", *args.labels]):
            style = {"ASTER": dict(color="red", linewidth=3),
                     "NDVI": dict(color="red", linestyle="dashed")}.get(name, {})
            ax.plot(x_axis[: len(s)], s, label=lab, **style)
        ax.legend(fontsize=12)
        ax.set_xlabel("Spatial frequencies (1/m)", fontsize=16)
        ax.set_ylabel("Attenuation (dB)", fontsize=16)
        ax.set_xlim(0, 0.0043)
        fig.savefig(os.path.join(args.out, f"{idx}_prediction_frequencies_single_tds.png"),
                    dpi=90, bbox_inches="tight")
        plt.close(fig)
        made += 1
    print(f"wrote {made} figure sets to {args.out}")


# ----------------------------------------------------------------- scatters

def cmd_scatters(argv):
    """Metric evolution vs the 1 km MODIS-ASTER bias/RMSE (reference
    :167-272). The reference reads a precomputed bias csv from the
    unformatted test_data (not shipped); here the 1 km discrepancy is
    computed from the formatted crops: the NN-upsampled input LST ('LST:')
    vs the ASTER crop."""
    parser = ArgumentParser(prog="compare_methods scatters")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--model", default="modelB_1009")
    parser.add_argument("--out", default="figures_test_dataset")
    args = parser.parse_args(argv)

    import pandas as pd

    plt = _mpl()
    os.makedirs(args.out, exist_ok=True)
    perf = pd.read_csv(os.path.join(args.results_dir, args.model, "performances.csv"),
                       index_col=0)
    rows = []
    for idx in _indices(args.results_dir, args.model):
        d = _load(os.path.join(args.results_dir, args.model, f"{idx}_dict_pred.pkl"))
        diff = d["LST:"] - d["LST_ASTER"]
        rows.append({"idx": idx, "bias_1km": float(diff.mean()),
                     "rmse_1km": float(np.sqrt((diff ** 2).mean()))})
    if not rows:
        parser.error(f"no dict_pred pkls for {args.model} under {args.results_dir}")
    bias = pd.DataFrame(rows).set_index("idx")
    perf.index = perf.index.astype(str)
    joined = bias.join(perf, how="inner").dropna(axis=1, how="all")

    metrics = [c for c in ("RMSE", "PSNR", "SSIM", "GSSIM", "LPIPS")
               if c in joined and joined[c].notna().any()]
    for xcol, xlabel, fname in [
        ("bias_1km", "Bias (absolute) MOD21-ASTER", "metrics_vs_bias_1km.png"),
        ("rmse_1km", "RMSE MOD21-ASTER at 1km", "metrics_vs_rmse_1km.png"),
    ]:
        fig, axes = plt.subplots(2, 3, figsize=(21, 14))
        for ax, m in zip(axes.ravel(), metrics):
            ax.scatter(np.abs(joined[xcol]), joined[m])
            ax.set_xlabel(xlabel)
            ax.set_ylabel(f"{m} ASTER 250m-MOD21_SR")
        for ax in axes.ravel()[len(metrics):]:
            ax.axis("off")
        path = os.path.join(args.out, f"{args.model}_{fname}")
        fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {path}")
    corr = {m: float(np.corrcoef(np.abs(joined["bias_1km"]), joined[m])[0, 1])
            for m in metrics}
    print("correlation of |bias_1km| with:",
          "  ".join(f"{k}={v:.3f}" for k, v in corr.items()))


# ------------------------------------------------------------------ seasons

def _season_counts(day_list) -> dict:
    """The reference's exact bucket rule (strict inequalities; winter wraps;
    boundary days 59/60, 151/152, ... fall where the reference puts them),
    compare_methods.py:44-74."""
    seasons = {"Winter": 0, "Spring": 0, "Summer": 0, "Fall": 0}
    for day in day_list:
        if day > 335 or day < 59:
            seasons["Winter"] += 1
        if 60 < day < 151:
            seasons["Spring"] += 1
        if 152 < day < 243:
            seasons["Summer"] += 1
        if 244 < day < 334:
            seasons["Fall"] += 1
    return seasons


def cmd_seasons(argv):
    parser = ArgumentParser(prog="compare_methods seasons")
    parser.add_argument("--dataset-csv", default="data/ModisDatasetB.csv")
    parser.add_argument("--split", default="Train")
    parser.add_argument("--time", default="day",
                        help="time-of-day filename filter (reference "
                             "compare_methods.py:42 keeps day granules only); "
                             "'Both' disables")
    parser.add_argument("--out", default="figures_test_dataset/seasons.png")
    args = parser.parse_args(argv)

    import pandas as pd

    df = pd.read_csv(args.dataset_csv)
    # manifest column is lowercase 'split' (data_preparation writes it, the
    # reference dataset.py:74 reads it); accept legacy 'Split' too
    split_col = "split" if "split" in df else ("Split" if "Split" in df else None)
    if split_col is not None:
        df = df[df[split_col] == args.split]
    if args.time != "Both":
        mask = df["LST"].astype(str).str.contains(args.time, regex=False)
        if not mask.any() and len(df) and "time" in df:
            # manifests from older pipeline layouts carry no time segment in
            # the path; fall back to the data_preparation 'time' column
            # (day->'D'/night->'N', reference data_preparation.py writes 'D')
            token = {"day": "D", "night": "N"}.get(args.time, args.time)
            mask = df["time"].astype(str).isin((token, args.time))
        if not mask.any() and len(df):
            print(f"warning: --time {args.time} matched no rows of "
                  f"{args.dataset_csv} (no path substring or 'time' column "
                  "match) — pass --time Both to disable the filter",
                  file=sys.stderr)
        df = df[mask]
    # day-of-year from the MODIS A-date token in the LST path
    # (reference: i.split('.')[-6][5:], e.g. .../MOD21A1D.A2020123....tif)
    def doy(path: str) -> int:
        for token in os.path.basename(str(path)).split("."):
            if token.startswith("A") and len(token) == 8 and token[1:].isdigit():
                return int(token[5:])
        raise ValueError(f"no A-date token in {path!r}")

    days = [doy(p) for p in df["LST"]]
    seasons = _season_counts(days)
    print("season counts:", seasons)
    plt = _mpl()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    plt.figure()
    plt.bar(list(seasons), list(seasons.values()), color="r")
    plt.savefig(args.out, bbox_inches="tight")
    print(f"wrote {args.out}")


# --------------------------------------------------------------- regression

def cmd_regression(argv):
    """LST-NDVI linear regression per training item + 3x3 hexbin panel +
    population statistics (reference :78-137)."""
    parser = ArgumentParser(prog="compare_methods regression")
    parser.add_argument("--dataset-csv", default="data/ModisDatasetB.csv")
    parser.add_argument("--statistics", default="data/statistics.json")
    parser.add_argument("--split", default="Train")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--out", default="figures_test_dataset/lst_ndvi_regression.png")
    args = parser.parse_args(argv)

    from scipy import stats as sps

    from sifsr_tpu_torch.data.datasets import ModisDataset, denormalize
    from sifsr_tpu_torch.data.statistics import Statistics

    stats = Statistics.from_json(args.statistics)
    ds = ModisDataset(args.dataset_csv, stats,
                      split=args.split, time="day", transf="norm")
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    slopes, intercepts, errors = [], [], []
    plt = _mpl()
    fig = plt.figure(figsize=(12, 12))
    for i in range(n):
        # regress in physical units as the reference does (Kelvin LST
        # nearest-up x4 vs raw NDVI, compare_methods.py:85-96)
        lst = denormalize(ds.lst[i], stats)
        ndvi = ds.ndvi[i] * stats.std_ndvi + stats.mean_ndvi
        lst_nn = np.repeat(np.repeat(lst, 4, 0), 4, 1)
        reg = sps.linregress(ndvi.ravel(), lst_nn.ravel())
        slopes.append(reg.slope)
        intercepts.append(reg.intercept)
        errors.append(float(np.sqrt(np.mean((lst_nn - (reg.slope * ndvi + reg.intercept)) ** 2))))
        if i < 9:
            ax = plt.subplot(3, 3, i + 1)
            ax.hexbin(ndvi.ravel(), lst_nn.ravel(), gridsize=120, cmap="jet")
            xs = [ndvi.min(), ndvi.max()]
            ax.plot(xs, [reg.slope * x + reg.intercept for x in xs], color="red")
            ax.grid()
            ax.set_title(f"LST = {reg.slope:.2g} NDVI {reg.intercept:+.2g}, "
                         f"R²={reg.rvalue ** 2:.2g}", fontsize=9)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out, dpi=90, bbox_inches="tight")
    print("Average Regression Parameters")
    print(f"Slope: mu={np.mean(slopes):.4g} sigma={np.std(slopes):.4g}")
    print(f"Intercept: mu={np.mean(intercepts):.4g} sigma={np.std(intercepts):.4g}")
    print(f"Average RMSE Linear: mu={np.mean(errors):.4g} sigma={np.std(errors):.4g}")
    print(f"wrote {args.out}")


# ----------------------------------------------------------------- timediff

def cmd_timediff(argv):
    """ASTER-MODIS time-difference statistics (reference :139-165). The real
    input is the *unformatted* test_data manifest (aster_modis_dataset_2.csv)
    whose column 9 holds the time difference in hours — not shipped with the
    reference snapshot, so pass --test-data-csv when available, or
    --synthetic to exercise the full code path on a generated manifest
    (Terra daytime overpass geometry: MODIS and ASTER ride the same
    satellite, so true same-day differences are minutes-scale; the synthetic
    column draws |dt| ~ N(15 min, 8 min), clearly labelled in the output)."""
    parser = ArgumentParser(prog="compare_methods timediff")
    parser.add_argument("--test-data-csv", default=None,
                        help="aster_modis_dataset_2.csv with the time-difference column")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="generate an N-pair synthetic manifest instead "
                             "of reading --test-data-csv")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--performances", default=None,
                        help="performances.csv to inner-join on pair index "
                             "(restricts stats to evaluated pairs)")
    parser.add_argument("--column", default=None,
                        help="time-difference column name (default: 9th column)")
    args = parser.parse_args(argv)

    import pandas as pd

    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        hours = rng.normal(0.25, 8.0 / 60.0, size=args.synthetic)
        hours *= rng.choice([-1.0, 1.0], size=args.synthetic)
        df = pd.DataFrame(
            {f"col{i}": np.zeros(args.synthetic) for i in range(8)}
            | {"time difference": hours.astype(np.float32)},
            index=np.arange(args.synthetic),
        )
        print(f"(synthetic manifest: {args.synthetic} pairs, seed {args.seed})")
    elif args.test_data_csv:
        df = pd.read_csv(args.test_data_csv, index_col=0)
    else:
        parser.error("pass --test-data-csv or --synthetic N")
    df.index = pd.to_numeric(df.index, errors="coerce")
    if args.performances:
        perf = pd.read_csv(args.performances, index_col=0)
        perf.index = pd.to_numeric(perf.index, errors="coerce")
        df = pd.merge(df, perf, left_index=True, right_index=True).dropna()
    col = df[args.column] if args.column else df.iloc[:, 8]
    minutes = 60.0 * np.asarray(col, np.float32)
    print("---- Statistics ----")
    print(f"Mean: {np.mean(minutes):.1f} min")
    print(f"Std: {np.std(minutes):.1f} min")
    print(f"Mini: {np.min(np.abs(minutes)):.1f} min")
    print(f"Maxi: {np.max(np.abs(minutes)):.1f} min")


# ----------------------------------------------------------------- contrast

def cmd_contrast(argv):
    """Contrast-inversion case study: ASTER vs SIF-NN-SR1 vs DMS 3-panel
    (reference :860-895)."""
    parser = ArgumentParser(prog="compare_methods contrast")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--index", default="0")
    parser.add_argument("--cnn", default="modelB_1009")
    parser.add_argument("--dms", default="DMS")
    parser.add_argument("--out", default="figures_test_dataset/contrast_inversion.png")
    args = parser.parse_args(argv)

    d_dms = _load(os.path.join(args.results_dir, args.dms, f"{args.index}_dict_pred.pkl"))
    d_cnn = _load(os.path.join(args.results_dir, args.cnn, f"{args.index}_dict_pred.pkl"))
    aster, dms, cnn = d_dms["LST_ASTER"], d_dms["LST_SR"], d_cnn["LST_SR"]
    mini, maxi = float(aster.min()), float(aster.max())

    plt = _mpl()
    fig, ax = plt.subplots(1, 3, figsize=(25, 9))
    for a, (img, title) in zip(ax, [(aster, "LST ASTER"), (cnn, "LST SR, CNN1"),
                                    (dms, "LST SR, DMS")]):
        im = a.imshow(img, cmap="jet", vmin=mini, vmax=maxi)
        a.axis("off")
        a.set_title(title, fontsize=25)
    fig.colorbar(im, cax=fig.add_axes([0.92, 0.15, 0.025, 0.7]))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out, dpi=90, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.out}")


SUBCOMMANDS = {
    "spectra": cmd_spectra,
    "figures": cmd_figures,
    "scatters": cmd_scatters,
    "seasons": cmd_seasons,
    "regression": cmd_regression,
    "timediff": cmd_timediff,
    "contrast": cmd_contrast,
}


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        return SUBCOMMANDS[argv[0]](argv[1:])
    # legacy flag-only invocation = the spectral batch job
    if argv and argv[0].startswith("--"):
        return cmd_spectra(argv)
    ArgumentParser(description=__doc__).parse_args(["--help"] if not argv else argv)


if __name__ == "__main__":
    main()
