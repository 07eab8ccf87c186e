"""Data-parallel training: one process per rank over `torch.distributed`.

Counterpart of `fullycnnspeechenhancement_tpu/parallel/dp.py`.  The JAX
package runs data parallelism in one process: the single-device step
under sharding annotations, with XLA inserting the gradient all-reduce and
the BN-moment all-reduce.  Here each rank is a process that holds the
replicated state (params, BN state, Adam state: broadcast from rank 0 once
by `replicate`, then kept equal by identical updates), receives the same
global batch as every other rank (same loader, same seed) and keeps rows
[r*B/N, (r+1)*B/N) of it (`shard_batch`, as the JAX package's
`shard_batch` puts them on device r).  Three hand-written collectives
give the same numbers as the JAX package's step over the global batch:

  1. sync BN: each BN layer's masked per-channel sum, sum of squares and
     count are summed over the ranks (`DataParallel.sum`) before
     mean = S/n and var = S2/n - mean^2, JAX's formula over the global
     batch.  The sum is an autograd Function whose backward is a sum as
     well, so each rank's gradient takes in the other ranks' loss terms
     that flow through the shared moments; the moving averages update
     from the global moments, so BN state stays equal on every rank;
  2. global masks: the batch-max frame mask uses the largest frame count
     of the global batch (`DataParallel.max`); under `mask_loss` the
     normalising mean of the [B, T] mask is global;
  3. gradients and metrics: after the backward the gradients (the
     blocked layers' dW from `ops/blocked_dw.py` among them) and the
     loss are summed over the ranks as one flat buffer, then every rank
     runs the same TF-Adam update.

The loss is divided by the configured *global* batch (train/step.py), so
the right reduction of the gradients is a sum.  `DistributedDataParallel`
would average, and `SyncBatchNorm` knows neither the masked biased moments
nor the TF BN; neither is used.

The device cache's int16 flats replicate: every rank commits the whole
corpus and materializes only its metadata rows (`shard_batch`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x; the backward sums the incoming
    gradients over the ranks the same way: each rank's x feeds every
    rank's y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class DataParallel:
    """This process's `rank` among the `world` ranks of a data-parallel
    group, and the group's collectives (`group` None: the default group)."""

    def __init__(self, world: int, rank: int = 0, group=None):
        self.world = int(world)
        self.rank = int(rank)
        self.group = group

    @classmethod
    def current(cls, world: Optional[int] = None, group=None) -> "DataParallel":
        """The group of this process, which must hold `world` ranks."""
        if not dist.is_initialized():
            raise ValueError(
                f"data_parallel={world} needs a process group of {world} ranks: "
                "`cli.train` starts them itself, or run under torchrun or with "
                "FCSE_MULTIHOST=1 (parallel/multihost.py)"
            )
        n = dist.get_world_size(group)
        if world is not None and n != world:
            raise ValueError(f"data_parallel={world}, but the process group has {n} ranks")
        return cls(n, dist.get_rank(group), group)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of `batch_size`."""
        if batch_size % self.world:
            raise ValueError(
                f"global batch {batch_size} not divisible by data-parallel degree {self.world}"
            )
        n = batch_size // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, differentiable (its backward sums too)."""
        return _AllReduceSum.apply(x, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Largest value over the ranks, elementwise (no gradient)."""
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def sum_flat(self, tensors):
        """Each tensor summed over the ranks, in one all-reduce of one flat
        buffer in their widest dtype (no gradient); returned in order,
        shape and dtype."""
        dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
        flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i : i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def replicate(state, dp: DataParallel):
    """Broadcast every tensor of `state` (any nesting of dicts, tuples and
    named tuples: a TrainState) from rank 0, in place; returns `state`."""

    def walk(x):
        if isinstance(x, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(x.data, src=0, group=dp.group)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(state)
    return state


def _rows_of(x, rows: slice, stacked: bool):
    if x is None:
        return None
    return x[:, rows] if stacked else x[rows]


def shard_batch(dp: DataParallel, batch):
    """This rank's rows of a global batch (any named tuple of [B, ...]
    arrays or tensors, None fields kept): a `train.step.Batch`, or the
    device cache's `train.cached_step.Meta`."""
    rows = dp.rows(len(batch.lengths))
    return type(batch)(*(_rows_of(x, rows, False) for x in batch))


def shard_stacked_batch(dp: DataParallel, batch):
    """This rank's rows of a stacked [K, B, ...] multi-step batch (or
    stacked `Meta`)."""
    rows = dp.rows(batch.lengths.shape[1])
    return type(batch)(*(_rows_of(x, rows, True) for x in batch))
