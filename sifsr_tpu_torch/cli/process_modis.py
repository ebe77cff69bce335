"""MODIS granule processing CLI (reference process_modis.py rebuilt).

    python -m sifsr_tpu_torch.cli.process_modis --product MOD21A1D --coverage 0.0 \
        --lst-dir data/hdf_files/MOD21A1D.061 --nirred-dir data/hdf_files/MOD09GQ.061

Per granule: read LST (+QC) -> vectorised 64x64 patch extraction with the
coverage/QC validity rules (process_modis.py:88-185) -> slice the matching
256x256 NDVI windows from the same-date MOD09GQ granule, dropping pairs with
zero NIR+Red denominators (:280-305) -> write per-patch GeoTIFFs + the
pairs_day.csv manifest. Optional: MOD44W water-mask column, georeference QA
histogram.

HDF decoding goes through geo.hdf4 (pure-python HDF4-EOS reader); GeoTIFF
inputs are accepted too for pipelines that pre-convert.

Port of ``sifsr_tpu/cli/process_modis.py`` (host numpy, same flags and
outputs), on the port's ``data.ingest``, ``geo.hdf4`` and ``geo.tiff``. The
georeference histogram needs matplotlib, imported after the patches and the
CSV are written, as in the JAX package.
"""

from __future__ import annotations

import glob
import os
import time as time_mod
from argparse import ArgumentParser

import numpy as np
import pandas as pd

from sifsr_tpu_torch.data.ingest import extract_lst_patches, extract_ndvi_windows, georeference_error
from sifsr_tpu_torch.geo.tiff import write_geotiff


def _date_of(path: str) -> str:
    """A-date token from a MODIS filename (e.g. MOD21A1D.A2017123.h18v04...)."""
    for part in os.path.basename(path).split("."):
        if part.startswith("A") and part[1:].isdigit():
            return part[1:]
    raise ValueError(f"no MODIS A-date in {path}")


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--product", default="MOD21A1D", choices=["MOD11A1", "MOD21A1D"])
    parser.add_argument("--lst-dir", default="./data/hdf_files/MOD21A1D.061")
    parser.add_argument("--nirred-dir", default="./data/hdf_files/MOD09GQ.061")
    # the default output dirs embed the time-of-day segment like the
    # reference layout (process_modis.py:459,472 "data/geotiff/.../day"):
    # downstream time filters (dataset.py:74-79 semantics, compare_methods
    # seasons) select granules by a filename substring, so the path must
    # carry it
    parser.add_argument("--out-lst", default=None,
                        help="default ./data/geotiff/LST/<time>")
    parser.add_argument("--out-ndvi", default=None,
                        help="default ./data/geotiff/NDVI/<time>")
    parser.add_argument("--pairs-out", default=None,
                        help="default ./data/pairs_<time>.csv (the reference "
                             "writes pairs_day.csv, process_modis.py:489)")
    parser.add_argument("--coverage", type=float, default=0.0)
    parser.add_argument("--window", type=int, default=64)
    parser.add_argument("--time", default="day", choices=["day", "night"])
    parser.add_argument("--workers", type=int, default=1,
                        help="granules processed concurrently (zlib decode "
                             "releases the GIL, so threads scale with cores)")
    args = parser.parse_args(argv)
    if args.out_lst is None:
        args.out_lst = f"./data/geotiff/LST/{args.time}"
    if args.out_ndvi is None:
        args.out_ndvi = f"./data/geotiff/NDVI/{args.time}"
    if args.pairs_out is None:
        args.pairs_out = f"./data/pairs_{args.time}.csv"

    from sifsr_tpu_torch.geo.hdf4 import read_modis_lst, read_modis_nir_red

    os.makedirs(args.out_lst, exist_ok=True)
    os.makedirs(args.out_ndvi, exist_ok=True)

    t0 = time_mod.time()
    lst_files = sorted(glob.glob(os.path.join(args.lst_dir, "*.hdf")))
    if not lst_files:
        parser.error(f"no .hdf granules under {args.lst_dir}")

    def process_granule(lst_path: str) -> list:
        date = _date_of(lst_path)
        nirred_matches = glob.glob(os.path.join(args.nirred_dir, f"*A{date}*.hdf"))
        if not nirred_matches:
            return []

        lst, qc, lst_gt = read_modis_lst(lst_path, time=args.time, with_qc=True)
        patches = extract_lst_patches(
            lst, qc, lst_gt,
            window=args.window,
            coverage=args.coverage,
            check_qc_bits=(args.product == "MOD11A1"),
        )
        if len(patches.block_index) == 0:
            return []

        red, nir, ndvi_gt = read_modis_nir_red(nirred_matches[0])
        ndvi_set, kept = extract_ndvi_windows(
            nir, red, ndvi_gt, patches.block_index, window=args.window * 4
        )

        stem_lst = os.path.basename(lst_path)[:-4]
        stem_ndvi = os.path.basename(nirred_matches[0])[:-4]
        rows = []
        for k, serial in enumerate(ndvi_set.block_index):
            lst_k = np.nonzero(patches.block_index == serial)[0][0]
            lst_name = os.path.join(args.out_lst, f"{stem_lst}.{serial}.tiff")
            ndvi_name = os.path.join(args.out_ndvi, f"{stem_ndvi}.{serial}.tiff")
            write_geotiff(lst_name, patches.patches[lst_k].astype(np.float32),
                          geotransform=tuple(patches.geotransforms[lst_k]))
            write_geotiff(ndvi_name, ndvi_set.patches[k].astype(np.float32),
                          geotransform=tuple(ndvi_set.geotransforms[k]))
            rows.append(
                (lst_name, ndvi_name,
                 georeference_error(patches.geotransforms[lst_k], ndvi_set.geotransforms[k]))
            )
        print(f"{stem_lst}: {len(rows)} pairs")
        return rows

    # manifest row order stays the sorted-granule order regardless of
    # worker completion order (executor.map preserves input order)
    if args.workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            per_granule = list(pool.map(process_granule, lst_files))
    else:
        per_granule = [process_granule(p) for p in lst_files]
    pair_rows = [row for rows in per_granule for row in rows]

    df = pd.DataFrame(pair_rows, columns=("LST", "NDVI", "georef_error"))
    df[["LST", "NDVI"]].to_csv(args.pairs_out)
    print(f"wrote {args.pairs_out}: {len(df)} pairs in {time_mod.time() - t0:.0f}s "
          f"(mean georef error {df['georef_error'].mean():.2f} m)")

    if len(df):
        # georeference-QA histogram (reference process_modis.py:496-503
        # writes pairs_day_error.png next to the pairs CSV)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig_path = os.path.splitext(args.pairs_out)[0] + "_error.png"
        plt.figure(figsize=(10, 7))
        plt.hist(df["georef_error"], bins=50)
        plt.xlabel("|Δx| + |Δy| georeference error (m)")
        plt.ylabel("pairs")
        plt.title("LST/NDVI pair georeference error")
        plt.savefig(fig_path)
        plt.close()
        print(f"wrote {fig_path}")


if __name__ == "__main__":
    main()
