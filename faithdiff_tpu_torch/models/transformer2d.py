"""Spatial transformer blocks of the SDXL UNet (counterpart of
`faithdiff_tpu/models/transformer2d.py`; linear projection only)."""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention_packed, multi_head_attention
from .layers import GroupNorm, LayerNorm

# packed [b, s, n*d] attention, as in the JAX package: no head transposes
# around the attention op. Read by `Attention.forward` at call time.
_BSND_ATTN = os.environ.get("FAITHDIFF_BSND_ATTN", "0") == "1"


class Attention(nn.Module):
    """Multi-head attention with separate bias-free q/k/v projections and a
    biased `to_out.0`; `cross_attention_dim=None` is self-attention. Under
    `_BSND_ATTN` (and without `upcast`) the projections go to
    `attention_packed` as they come out of the Linear layers."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None,
                 upcast: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.upcast = heads, dim_head, upcast
        kv_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        if _BSND_ATTN and not self.upcast:
            out = attention_packed(self.to_q(x), self.to_k(context),
                                   self.to_v(context), self.heads)
            return self.to_out[0](out.to(x.dtype))
        b, sq, _ = x.shape
        sk = context.shape[1]

        def heads_first(t, s):
            return t.reshape(b, s, self.heads, self.dim_head).transpose(1, 2) \
                .contiguous()

        q = heads_first(self.to_q(x), sq)
        k = heads_first(self.to_k(context), sk)
        v = heads_first(self.to_v(context), sk)
        if self.upcast:
            q, k, v = q.float(), k.float(), v.float()
        out = multi_head_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, sq, -1).to(x.dtype)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)          # exact erf GELU, as diffusers


class FeedForward(nn.Module):
    """`net.0` GEGLU, `net.1` (dropout, a no-op at inference), `net.2`."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int, upcast_attention: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head, upcast=upcast_attention)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim,
                               upcast=upcast_attention)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> linear proj_in -> transformer blocks -> proj_out,
    plus the residual (SDXL `use_linear_projection=True`)."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 depth: int, cross_attention_dim: int,
                 norm_num_groups: int = 32, upcast_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim,
                                  upcast_attention)
            for _ in range(depth)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        hidden = self.proj_out(hidden)
        # back to NCHW memory: the next GroupNorm kernel takes contiguous x
        return (x + hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)).contiguous()
