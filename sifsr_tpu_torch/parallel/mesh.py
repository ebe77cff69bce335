"""Data parallelism over ``torch.distributed``: one process per device.

Port of ``sifsr_tpu/parallel/mesh.py``. The network is ~283k parameters while
each 256² training example is ~0.8 MB, so the parallelism is 1-D data
parallelism over a ('data',) group: parameters, optimiser state and BatchNorm
statistics replicated, batches split on their leading axis.

In the JAX package the data-parallel step *is* the single-device step on the
global batch: XLA's partitioner all-reduces the gradients and computes the
train-mode BatchNorm statistics over the global batch. Here each process runs
the step on its own shard, and the step built with ``mesh`` (``train.step``)
does what the partitioner does:

- every BatchNorm normalises with the global batch's moments
  (``CrossRankBatchNorm2d``: the mean and biased variance over all ranks,
  the unbiased variance and the global count for the running update),
  reduced by an all-reduce that autograd differentiates;
- the gradients are averaged across the ranks before Adam, so Adam takes the
  same update on every rank;
- the ds loss is the global batch's (``losses.ds_loss(mesh=...)``; kernel M
  runs on each rank's shard) and the metrics are averaged across the ranks.

``nn.SyncBatchNorm`` is not used: it refuses CPU tensors, and the CPU tests
must run the code the card runs. The process group is the caller's:
``torch.distributed.init_process_group(backend, init_method='tcp://...',
world_size=..., rank=...)`` comes first. NCCL takes one card per rank; gloo
also takes CPU tensors, and CUDA tensors of ranks that share a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from sifsr_tpu_torch.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "make_parallel_train_step",
    "make_parallel_apply",
    "CrossRankBatchNorm2d",
    "convert_batchnorm",
    "global_mean",
    "gather_rows",
    "average_tensors",
    "global_range",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel group: the process group its collectives use,
    this process's rank in it, its size and the device this rank computes
    on."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: int = 0, device: str | torch.device = "cuda") -> Mesh | None:
    """The group of the first ``n_devices`` ranks of the initialised default
    group (0 = all). Every rank calls it; a rank outside the group gets None.

    ``device``: 'cuda' computes on ``cuda:<rank % device_count>`` (so ranks
    that outnumber the cards share them, which gloo allows and NCCL does
    not); 'cpu' or an indexed device as given."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group "
                           "(address, world size and rank) first")
    world = dist.get_world_size()
    size = n_devices or world
    if not 1 <= size <= world:
        raise ValueError(f"n_devices={n_devices} with a world of {world} processes")
    group = dist.group.WORLD if size == world else dist.new_group(list(range(size)))
    rank = dist.get_rank()
    if rank >= size:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group=group, rank=rank, size=size, device=dev)


def _rows(n: int, mesh: Mesh) -> slice:
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} devices")
    shard = n // mesh.size
    return slice(mesh.rank * shard, (mesh.rank + 1) * shard)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch dict (numpy arrays or tensors),
    on the mesh's device. The leading axis must split evenly."""
    out = {}
    for k, v in batch.items():
        part = v[_rows(v.shape[0], mesh)]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out[k] = part.to(mesh.device)
    return out


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Move ``module`` to the mesh's device and give every rank the first
    rank's parameters and buffers (in place; Parameter objects kept)."""
    module.to(mesh.device)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0, group=mesh.group)   # the group's rank 0 is global rank 0
    return module


def make_parallel_train_step(train_step, mesh: Mesh):
    """Wrap a (state, batch) -> (state, metrics) step built by
    ``train.step.make_train_step(..., mesh=mesh)`` so that it takes the
    global batch: each rank keeps its rows, and the step's collectives make
    the update the single-device step's on the whole batch."""
    if getattr(train_step, "mesh", None) is not mesh:
        raise ValueError("make_parallel_train_step needs a step built with "
                         "make_train_step(..., mesh=mesh) for this mesh")

    def step(state, batch: dict):
        return train_step(state, shard_batch(batch, mesh))

    return step


def make_parallel_apply(apply_fn, mesh: Mesh):
    """Shard a pure (variables, batch) -> outputs forward across the mesh:
    each rank runs its rows, and the outputs stay sharded (no gather)."""
    def apply(variables, batch: dict):
        return apply_fn(variables, shard_batch(batch, mesh))

    return apply


def _all_reduce_grad(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the ranks, differentiable: the backward sums the gradients."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=mesh.group)


def global_mean(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean (equal shards: the global
    batch's mean), differentiable; ``t`` itself without a group of two or
    more."""
    if mesh is None or mesh.size == 1:
        return t
    return _all_reduce_grad(t, mesh) / mesh.size


@torch.no_grad()
def average_tensors(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the ranks, in place, in one
    all-reduce (gradients before Adam, step metrics)."""
    if mesh.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def global_range(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """max - min of ``t`` over every rank's shard (the metrics' batch-wide
    data range), one all-reduce."""
    mm = torch.stack([t.max(), -t.min()])
    dist.all_reduce(mm, op=dist.ReduceOp.MAX, group=mesh.group)
    return mm[0] + mm[1]


@torch.no_grad()
def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's rows of ``t`` stacked in rank order, on every rank.
    An all-reduce of zero-padded buffers (gloo takes no all-gather of CUDA
    tensors); adding zeros is exact, so the rows keep their bits."""
    n = t.shape[0]
    out = t.new_zeros((mesh.size * n, *t.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = t
    dist.all_reduce(out, group=mesh.group)
    return out


class CrossRankBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode moments are the global batch's:
    the per-channel sums and the count, then the sums of squared deviations
    from the global mean, are all-reduced over the mesh (in float64, through
    autograd), as the JAX package's ``TorchBatchNorm`` computes them under
    the partitioner: biased variance to normalise, unbiased for the running
    update (momentum 0.1), statistics in float32 and the output in the
    input's dtype. In eval mode, or on a group of one, it is
    ``nn.BatchNorm2d``."""

    def __init__(self, num_features: int, mesh: Mesh, **kwargs):
        super().__init__(num_features, **kwargs)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.mesh.size == 1:
            return super().forward(x)
        c = x.shape[1]
        x32 = x.float()
        count = torch.full((1,), x.numel() // c, dtype=torch.float64, device=x.device)
        sums = _all_reduce_grad(torch.cat([x32.sum(dim=(0, 2, 3)).double(), count]), self.mesh)
        n = sums[-1].detach()
        mean = (sums[:-1] / n).float()
        d = x32 - mean[None, :, None, None]
        var = (_all_reduce_grad(d.square().sum(dim=(0, 2, 3)).double(), self.mesh) / n).float()
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / (n - 1).clamp_min(1)).float())
            self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = d * inv[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


def convert_batchnorm(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace every ``nn.BatchNorm2d`` of ``module`` by a
    ``CrossRankBatchNorm2d`` on ``mesh`` holding the same Parameter and
    buffer objects (an optimiser built before keeps working, and the state
    dict's keys stay). In place; returns ``module``."""
    for name, child in module.named_children():
        if isinstance(child, CrossRankBatchNorm2d):
            if child.mesh is not mesh:
                raise ValueError(f"{name} is already bound to another mesh")
            continue
        if isinstance(child, nn.BatchNorm2d):
            bn = CrossRankBatchNorm2d(child.num_features, mesh, eps=child.eps,
                                      momentum=child.momentum, affine=child.affine,
                                      track_running_stats=child.track_running_stats)
            bn.weight, bn.bias = child.weight, child.bias
            for buf in ("running_mean", "running_var", "num_batches_tracked"):
                setattr(bn, buf, getattr(child, buf))
            bn.train(child.training)
            setattr(module, name, bn)
        else:
            convert_batchnorm(child, mesh)
    return module
