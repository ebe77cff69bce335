"""Dataset normalisation statistics (reference data_preparation.py:68-105).

The same frozen dataclass as the JAX package, with the reference's JSON field
names: global train-split max/min of LST and mean/std of LST and NDVI, and
its numpy ``compute_statistics``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

__all__ = ["Statistics", "compute_statistics"]


@dataclasses.dataclass(frozen=True)
class Statistics:
    maxi: float
    mini: float
    mean_lst: float
    std_lst: float
    mean_ndvi: float
    std_ndvi: float

    @classmethod
    def from_json(cls, path: str) -> "Statistics":
        with open(path) as f:
            d = json.load(f)
        return cls(
            maxi=d["maxi"],
            mini=d["mini"],
            mean_lst=d["mean_lst"],
            std_lst=d["std_lst"],
            mean_ndvi=d["mean_ndvi"],
            std_ndvi=d["std_ndvi"],
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)


def compute_statistics(lst_images, ndvi_images) -> Statistics:
    """Global *pooled-pixel* statistics over iterables of LST / NDVI arrays
    (train split only; reference data_preparation.py:85-102 concatenates all
    images and takes one mean/std over every pixel). Computed streaming via
    sum / sum-of-squares so the whole dataset never has to be resident."""
    maxi, mini = -np.inf, np.inf
    s = ss = n = 0.0
    for lst in lst_images:
        lst = np.asarray(lst, np.float64)
        maxi = max(maxi, float(lst.max()))
        mini = min(mini, float(lst.min()))
        s += lst.sum()
        ss += np.square(lst).sum()
        n += lst.size
    mean_lst = s / n
    std_lst = float(np.sqrt(ss / n - mean_lst**2))

    s = ss = n = 0.0
    for ndvi in ndvi_images:
        ndvi = np.asarray(ndvi, np.float64)
        s += ndvi.sum()
        ss += np.square(ndvi).sum()
        n += ndvi.size
    mean_ndvi = s / n
    std_ndvi = float(np.sqrt(ss / n - mean_ndvi**2))

    return Statistics(
        maxi=maxi,
        mini=mini,
        mean_lst=float(mean_lst),
        std_lst=std_lst,
        mean_ndvi=float(mean_ndvi),
        std_ndvi=std_ndvi,
    )
