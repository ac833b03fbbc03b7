"""The data axis and ZeRO's sharding rule (counterpart of
`faithdiff_tpu/parallel/mesh.py`).

The data axis is a process group (the default one), every rank one card:
training splits each batch over it (gradients averaged at each optimizer
step), the restore splits each UNet call's tiles over it; a rank count
stands for it where no group is needed. `shard_leading_divisible` is JAX's
rule for optimizer state: a tensor whose first dim the ranks divide is
sharded along it (`Shard(0)`), any other replicated (`Replicate()`).
`LeadingShards` applies the rule to named tensors on the ranks of a
group: each rank's rows, gathering them back, and which rank counts a
tensor in a global sum.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard


def shard_leading_divisible(tree: Any, n: int) -> Any:
    """The placement of each tensor of `tree` (nested dicts, lists or tuples
    of tensors) over a data axis of `n` ranks: `Shard(0)` when its first dim
    is at least n and n divides it, `Replicate()` otherwise (scalars too),
    as JAX's rule gives P("data") or P()."""
    if isinstance(tree, Mapping):
        return {k: shard_leading_divisible(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_leading_divisible(v, n) for v in tree)
    shape = tuple(getattr(tree, "shape", ()))
    if len(shape) >= 1 and shape[0] % n == 0 and shape[0] >= n:
        return Shard(0)
    return Replicate()


class LeadingShards:
    """`shard_leading_divisible` over named tensors on the ranks of `group`
    (default: the default group): a sharded tensor's rank r holds rows
    [r * d0 / N, (r + 1) * d0 / N), a replicated one is whole on every rank."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.rows: Dict[str, Optional[slice]] = {}
        for name, spec in shard_leading_divisible(dict(tensors), self.world).items():
            per = tensors[name].shape[0] // self.world if spec == Shard(0) else 0
            self.rows[name] = (slice(self.rank * per, (self.rank + 1) * per)
                               if per else None)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `t` (a view), or `t` if it is replicated."""
        rows = self.rows[name]
        return t if rows is None else t[rows]

    def counts(self, name: str) -> bool:
        """Whether this rank adds `name`'s local part to a sum over ranks:
        every rank its own shard, rank 0 alone a replicated tensor."""
        return self.rows[name] is not None or self.rank == 0

    def gather(self, name: str, local: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor from every rank's `local` part, into `out`
        (in place; `local` may be a view of it) or a new tensor."""
        if self.rows[name] is None:
            if out is not None and out.data_ptr() != local.data_ptr():
                out.copy_(local)
            return local if out is None else out
        if out is None:
            out = local.new_empty((local.shape[0] * self.world, *local.shape[1:]))
        dist.all_gather(list(out.chunk(self.world)), local.detach().clone(),
                        group=self.group)
        return out
