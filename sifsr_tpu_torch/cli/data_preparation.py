"""Dataset preparation CLI (reference data_preparation.py rebuilt).

    python -m sifsr_tpu_torch.cli.data_preparation --pairs data/pairs_day.csv

Port of ``sifsr_tpu/cli/data_preparation.py`` (host numpy and pandas, same
flags and outputs), on the port's ``geo.tiff`` and ``data.statistics``.

Reproduces the reference bit-for-bit where it matters for downstream parity:
- the Train/Val split uses ``random.seed(42)`` + ``random.choices(['Train',
  'Val'], [0.6, 0.4])`` per row in pairs-file order (data_preparation.py:
  32-39) — the exact same RNG stream, so a dataset produced by the reference
  pipeline splits identically here;
- rows are shuffled with the pandas sample(frac=1, random_state=42) call;
- statistics are global pooled-pixel mean/std + max/min over the Train split
  (data_preparation.py:85-102), written to data/statistics.json with the
  reference's field names.

The legacy ModisDatasetA stacked-image variant (unused by every published
model; SURVEY.md §2 'dead code') is not emitted.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from random import choices, seed

import pandas as pd

from sifsr_tpu_torch.data.statistics import compute_statistics
from sifsr_tpu_torch.geo.tiff import read_geotiff


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--pairs", default="./data/pairs_day.csv")
    parser.add_argument("--out", default="./data/ModisDatasetB.csv")
    parser.add_argument("--statistics-out", default="./data/statistics.json")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train-fraction", type=float, default=0.6)
    args = parser.parse_args(argv)

    df = pd.read_csv(args.pairs)
    df = df.drop(columns=df.columns[0])
    df["time"] = "D"

    seed(args.seed)
    split_choices = ["Train", "Val"]
    proportions = [args.train_fraction, 1.0 - args.train_fraction]
    df["split"] = [choices(split_choices, proportions)[0] for _ in range(len(df))]

    df = df.sample(frac=1, random_state=args.seed).reset_index(drop=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    df.to_csv(args.out)
    print(f"wrote {args.out}: {len(df)} pairs "
          f"({(df['split'] == 'Train').sum()} train / {(df['split'] == 'Val').sum()} val)")

    train = df.loc[(df["split"] == "Train") & (df["time"] == "D")]
    stats = compute_statistics(
        (read_geotiff(p).array for p in train["LST"]),
        (read_geotiff(p).array for p in train["NDVI"]),
    )
    stats.to_json(args.statistics_out)
    print(f"wrote {args.statistics_out}: {stats}")


if __name__ == "__main__":
    main()
