"""Collective helpers over a process group, and the per-rank batch.

Port of `pixelsplat_tpu/parallel/mesh.py`. The JAX package lays a 1-D
"data" mesh over every device, shards the batch's leading axis over it
(`shard_batch`; across hosts `make_array_from_process_local_data` joins
each process's local batch into the global one) and lets XLA insert the
gradient `pmean`. Here there is no global array: each rank's loader
already yields that rank's share of the global batch (the data module
takes `global_rank` and `world_size`, as DDP expects), the parameters are
replicated by broadcast, and the step averages its gradients explicitly
with `all_reduce_mean_`. `rank_slice` and `shard_batch` give a rank its
share of a batch that every rank holds whole (tests and `chip_smoke.py`).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Optional

import torch
import torch.distributed as dist


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _flat_buckets(tensors: Iterable[torch.Tensor]) -> list[list[torch.Tensor]]:
    """The tensors grouped by (device, dtype), in order."""
    buckets: dict = defaultdict(list)
    for t in tensors:
        buckets[(t.device, t.dtype)].append(t)
    return list(buckets.values())


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group: Optional[dist.ProcessGroup] = None) -> int:
    """Sum each tensor over the group, in place: one flat buffer and one
    collective per (device, dtype). Returns the bytes reduced."""
    moved = 0
    for bucket in _flat_buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
        moved += flat.numel() * flat.element_size()
    return moved


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group: Optional[dist.ProcessGroup] = None) -> int:
    """Average each tensor over the group, in place (the JAX step's
    `pmean`): the sum over ranks divided by the world size. Returns the
    bytes reduced."""
    tensors = list(tensors)
    moved = all_reduce_sum_(tensors, group)
    inv = 1.0 / world_size(group)
    for bucket in _flat_buckets(tensors):
        torch._foreach_mul_(bucket, inv)
    return moved


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0, group: Optional[dist.ProcessGroup] = None) -> None:
    """Overwrite each tensor with rank `src`'s, in place: one flat buffer
    and one collective per (device, dtype)."""
    for bucket in _flat_buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def rank_slice(global_size: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous share of `global_size` examples."""
    if global_size % world:
        raise ValueError(f"a global batch of {global_size} does not split over {world} ranks")
    share = global_size // world
    return slice(rank * share, (rank + 1) * share)


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s share of every leaf of a nested batch dict (arrays,
    tensors or lists along their first axis)."""
    def take(value):
        if isinstance(value, dict):
            return {k: take(v) for k, v in value.items()}
        return value[rank_slice(len(value), rank, world)]

    return take(batch)
