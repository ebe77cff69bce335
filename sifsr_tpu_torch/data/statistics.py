"""Dataset normalisation statistics (reference data_preparation.py:68-105).

The same frozen dataclass as the JAX package, with the reference's JSON field
names: global train-split max/min of LST and mean/std of LST and NDVI.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["Statistics"]


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
