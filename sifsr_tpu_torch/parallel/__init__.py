"""Data parallelism over torch.distributed: data-parallel training and
batched inference, one process per device."""

from sifsr_tpu_torch.parallel.mesh import (
    CrossRankBatchNorm2d,
    Mesh,
    convert_batchnorm,
    make_mesh,
    make_parallel_apply,
    make_parallel_train_step,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "make_parallel_train_step",
           "make_parallel_apply", "CrossRankBatchNorm2d", "convert_batchnorm"]
