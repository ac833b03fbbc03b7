"""Tensor parallelism for the SDXL UNet (counterpart of
`faithdiff_tpu/parallel/tp.py`).

JAX's plan, Megatron-style, as placements of the port's state-dict tensors
(`nn.Linear` weights are [out, in], so JAX's column-sharded kernel
P(None, "model") is `Shard(0)` here and its row-sharded P("model", None)
is `Shard(1)`):
- the attention projections `to_q` / `to_k` / `to_v` and the GEGLU
  projection `ff.net.0.proj`: column-sharded (output features);
- `to_out.0` and `ff.net.2`: row-sharded (input features);
- everything else (convolutions, norms, embeddings, biases): replicated.
A weight is sharded only where the ranks divide the sharded dim, as in
JAX (for GEGLU, each of its two halves). JAX's GSPMD may split an
attention inside a head; written out by hand each rank attends over
whole heads, so an attention whose head count the ranks do not divide
stays replicated here (SDXL's 10-head blocks at 4 ranks).

`apply_tp` applies the plan in place for the forward pass (inference): a
column-sharded projection keeps this rank's output rows (for GEGLU the
same rows of both halves, so the gate stays local, and the bias rows with
them), the attention runs on the local heads, and a row-sharded projection
multiplies its slice of the input features, sums the ranks' partial
products with one `all_reduce`, then adds its whole bias.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..models.transformer2d import Attention, FeedForward


def _attention_shards(attn: Attention, n: int) -> bool:
    return attn.heads % n == 0


def unet_tp_plan(unet: nn.Module, n: int) -> Dict[str, object]:
    """The placement of each tensor of `unet.state_dict()` over `n` ranks:
    `Shard(0)` (column), `Shard(1)` (row) or `Replicate()`."""
    plan = {name: Replicate() for name in unet.state_dict()}
    for prefix, m in unet.named_modules():
        if isinstance(m, Attention) and _attention_shards(m, n):
            for proj in ("to_q", "to_k", "to_v"):
                plan[f"{prefix}.{proj}.weight"] = Shard(0)
            plan[f"{prefix}.to_out.0.weight"] = Shard(1)
        elif isinstance(m, FeedForward):
            proj, out = m.net[0].proj, m.net[2]
            if (proj.out_features // 2) % n == 0:
                plan[f"{prefix}.net.0.proj.weight"] = Shard(0)
            if out.in_features % n == 0:
                plan[f"{prefix}.net.2.weight"] = Shard(1)
    return plan


class RowParallelLinear(nn.Module):
    """A Linear whose weight holds this rank's input features: the partial
    product is summed over `group` (one all_reduce), then the whole bias
    is added. Forward only."""

    def __init__(self, linear: nn.Linear, rank: int, n: int, group=None):
        super().__init__()
        k = linear.in_features // n
        self.weight = nn.Parameter(linear.weight.detach()[:, rank * k:(rank + 1) * k]
                                   .clone(), requires_grad=False)
        self.bias = linear.bias
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.weight)
        dist.all_reduce(out, group=self.group)
        return out if self.bias is None else out + self.bias


def _keep_rows(linear: nn.Linear, rows: torch.Tensor) -> None:
    """`linear` cut to the output features `rows`, in place."""
    linear.weight = nn.Parameter(linear.weight.detach()[rows].clone(),
                                 requires_grad=False)
    if linear.bias is not None:
        linear.bias = nn.Parameter(linear.bias.detach()[rows].clone(),
                                   requires_grad=False)
    linear.out_features = len(rows)


@torch.no_grad()
def apply_tp(unet: nn.Module, group=None) -> nn.Module:
    """Shard `unet`'s transformer projections over the ranks of `group`
    (default: the default group) by `unet_tp_plan`, in place; returns it.
    Every rank must hold the same weights before."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    for m in list(unet.modules()):
        if isinstance(m, Attention) and _attention_shards(m, n):
            k = m.to_q.out_features // n
            rows = torch.arange(rank * k, (rank + 1) * k)
            for proj in (m.to_q, m.to_k, m.to_v):
                _keep_rows(proj, rows)
            m.heads //= n
            m.to_out[0] = RowParallelLinear(m.to_out[0], rank, n, group)
        elif isinstance(m, FeedForward):
            proj = m.net[0].proj
            half = proj.out_features // 2
            if half % n == 0:
                k = half // n
                mine = torch.arange(rank * k, (rank + 1) * k)
                _keep_rows(proj, torch.cat([mine, half + mine]))
            if m.net[2].in_features % n == 0:
                m.net[2] = RowParallelLinear(m.net[2], rank, n, group)
    return unet
