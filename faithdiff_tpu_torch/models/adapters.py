"""FaithDiff adapters: the LQ-feature condition embedding and the
information-transformer fusion stack (counterpart of
`faithdiff_tpu/models/adapters.py`).

The reference feeds `[batch, h*w, 640]` tokens to `nn.MultiheadAttention`
with `batch_first=False`, so the *sequence* axis is the model batch (the
CFG uncond/cond pair at inference) and every pixel is an independent
attention batch entry. The released weights were learned that way, so the
port keeps it: attention mixes the `group` axis per pixel (g=2 at tiled
inference, one group per tile's CFG pair; g=None = the whole batch). Under
data parallelism the whole batch is the global one, as in JAX, where the
batch is sharded over the mesh and the attention still spans it: the
ranks' tokens are all-gathered (`dist_group`) and each rank keeps its
own rows of the result.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention_reference
from .layers import GroupNorm, LayerNorm, quick_gelu


class ConditionEmbedding(nn.Module):
    """GroupNorm -> 3x3 conv -> SiLU -> zero-init 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int = 320):
        super().__init__()
        self.norm_in = GroupNorm(32, in_channels, 1e-6)
        self.conv_in = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.conv_out = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.conv_in(self.norm_in(x))))


class MultiheadAttention(nn.Module):
    """`nn.MultiheadAttention`'s parameters (packed `in_proj_weight` /
    `in_proj_bias`, `out_proj`), applied to ``[..., seq, d_model]`` tokens
    with the plain attention math (fp32 scores, probs cast to v's dtype)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, s, d = x.shape
        hd = d // self.n_head
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)

        def heads_first(t):
            return t.reshape(*lead, s, self.n_head, hd).transpose(-3, -2)

        out = attention_reference(heads_first(q), heads_first(k),
                                  heads_first(v), hd ** -0.5)
        return self.out_proj(out.transpose(-3, -2).reshape(*lead, s, d))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + 2x QuickGELU MLP, both residual."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = MultiheadAttention(d_model, n_head)
        self.ln_1 = LayerNorm(d_model)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(d_model, d_model * 2),
                                  "c_proj": nn.Linear(d_model * 2, d_model)})
        self.ln_2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., seq, d_model]; attention runs over `seq`."""
        x = x + self.attn(self.ln_1(x))
        h = quick_gelu(self.mlp["c_fc"](self.ln_2(x)))
        return x + self.mlp["c_proj"](h)


class _GatherRows(torch.autograd.Function):
    """The ranks' [b, ...] tensors concatenated in rank order; the backward
    sums the gradient over the ranks (each rank's loss reaches every rank's
    rows) and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        b = grad.shape[0] // dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return grad[rank * b:(rank + 1) * b], None


def information_fusion(layers: nn.ModuleList, proj: nn.Linear,
                       sample: torch.Tensor, cond: torch.Tensor,
                       group_size: Optional[int] = None,
                       dist_group=None) -> torch.Tensor:
    """The fusion forward over UNet post-conv_in features and the condition
    embedding, both [B, C, H, W]; returns the projected `feat_alpha`
    [B, C', H, W]. Attention mixes each contiguous group of `group_size`
    batch entries per pixel (None: the whole batch is one group; with a
    `dist_group`, the batch of all its ranks, of which this rank's rows
    are returned)."""
    tokens = torch.cat([sample, cond], dim=1)                # [b, 2c, h, w]
    if dist_group is not None and group_size is None:
        local = tokens.shape[0]
        feat = information_fusion(layers, proj, *_GatherRows.apply(
            tokens, dist_group).split(sample.shape[1], dim=1))
        rank = dist.get_rank(dist_group)
        return feat[rank * local:(rank + 1) * local]
    b, c, h, w = sample.shape
    g = b if group_size is None else group_size
    if b % g:
        raise ValueError(f"fusion group size {g} does not divide batch {b}")
    # [b//g groups, pixels, g (the attention sequence), 2c], made contiguous
    # once: the residual adds keep it so, and each LayerNorm reads its rows
    # in place
    tokens = tokens.reshape(b // g, g, 2 * c, h * w).permute(0, 3, 1, 2) \
        .contiguous()
    for layer in layers:
        tokens = layer(tokens)
    feat = proj(tokens)                                      # [b//g, hw, g, c']
    return feat.permute(0, 2, 3, 1).reshape(b, -1, h, w).contiguous()


class InformationTransformer(nn.Module):
    """The fusion stack as a module of its own. Its parameters carry the
    reference's names (`information_transformer_layes.*`,
    `spatial_ch_projs.*`); the UNet registers the same two attributes
    directly, so its state dict matches FaithDiff.bin."""

    def __init__(self, num_layers: int = 2, d_model: int = 640,
                 n_head: int = 8, out_channels: int = 320):
        super().__init__()
        self.information_transformer_layes = nn.ModuleList([
            ResidualAttentionBlock(d_model, n_head)
            for _ in range(num_layers)])
        self.spatial_ch_projs = nn.Linear(d_model, out_channels)
        nn.init.zeros_(self.spatial_ch_projs.weight)
        nn.init.zeros_(self.spatial_ch_projs.bias)

    def forward(self, sample: torch.Tensor, cond: torch.Tensor,
                group_size: Optional[int] = None) -> torch.Tensor:
        return information_fusion(self.information_transformer_layes,
                                  self.spatial_ch_projs, sample, cond,
                                  group_size)
