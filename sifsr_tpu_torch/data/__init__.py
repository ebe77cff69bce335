"""Host data pipeline of the port: normalisation statistics, manifests,
batch iterators."""

from sifsr_tpu_torch.data.datasets import (
    ArrayDataset,
    ModisDataset,
    degrade_batch_scale_invariance,
    denormalize,
    make_synthetic_dataset,
    normalize,
    prepare_batch,
)
from sifsr_tpu_torch.data.statistics import Statistics, compute_statistics

__all__ = ["Statistics", "compute_statistics", "ArrayDataset", "ModisDataset", "normalize",
           "denormalize", "prepare_batch", "degrade_batch_scale_invariance",
           "make_synthetic_dataset"]
