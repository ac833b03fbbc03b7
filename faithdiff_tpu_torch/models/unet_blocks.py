"""UNet and VAE composite blocks (counterpart of
`faithdiff_tpu/models/unet_blocks.py`), NCHW."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.attention import multi_head_attention
from .layers import GroupNorm, maybe_checkpoint
from .resnet import Downsample2D, ResnetBlock2D, Upsample2D
from .transformer2d import Transformer2DModel


# ---------------------------------------------------------------------------
# UNet down / mid / up blocks
# ---------------------------------------------------------------------------

class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels, groups, eps)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels,
                                                         out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context=None):
        res = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 heads: int, transformer_depth: int, cross_attention_dim: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 groups: int = 32, eps: float = 1e-5,
                 upcast_attention: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels, groups, eps)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, heads, out_channels // heads,
                               transformer_depth, cross_attention_dim, groups,
                               upcast_attention)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels,
                                                         out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context=None):
        res = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, channels: int, temb_channels: int, heads: int,
                 transformer_depth: int, cross_attention_dim: int,
                 groups: int = 32, eps: float = 1e-5,
                 upcast_attention: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels, groups, eps)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, heads, channels // heads,
                               transformer_depth, cross_attention_dim, groups,
                               upcast_attention)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UpBlock2D(nn.Module):
    """`skip_channels[i]` is the channel count of the skip that resnet i
    concatenates (taken from the end of the down-path list)."""

    def __init__(self, prev_channels: int, out_channels: int,
                 skip_channels: Sequence[int], temb_channels: int,
                 add_upsample: bool = True, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_channels if i == 0 else out_channels) + skip,
                          out_channels, temb_channels, groups, eps)
            for i, skip in enumerate(skip_channels)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels,
                                                     out_channels)])
                           if add_upsample else None)

    def forward(self, x, res: List[torch.Tensor], temb, context=None,
                upsample_size=None):
        res = list(res)
        for resnet in self.resnets:
            x = resnet(torch.cat([x, res.pop()], dim=1), temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x


class CrossAttnUpBlock2D(nn.Module):
    def __init__(self, prev_channels: int, out_channels: int,
                 skip_channels: Sequence[int], temb_channels: int, heads: int,
                 transformer_depth: int, cross_attention_dim: int,
                 add_upsample: bool = True, groups: int = 32,
                 eps: float = 1e-5, upcast_attention: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_channels if i == 0 else out_channels) + skip,
                          out_channels, temb_channels, groups, eps)
            for i, skip in enumerate(skip_channels)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, heads, out_channels // heads,
                               transformer_depth, cross_attention_dim, groups,
                               upcast_attention)
            for _ in skip_channels])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels,
                                                     out_channels)])
                           if add_upsample else None)

    def forward(self, x, res: List[torch.Tensor], temb, context,
                upsample_size=None):
        res = list(res)
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(torch.cat([x, res.pop()], dim=1), temb), context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x


# ---------------------------------------------------------------------------
# VAE blocks (also the FaithDiff denoise encoder's)
# ---------------------------------------------------------------------------

class DownEncoderBlock2D(nn.Module):
    """`remat` checkpoints each ResNet on its own (the JAX block's
    per-ResNet remat: a whole block's recompute would keep both ResNets'
    temporaries live at once)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 groups: int = 32, eps: float = 1e-6, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, None, groups, eps)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            out_channels, out_channels, pad_mode="vae")])
            if add_downsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = maybe_checkpoint(self.remat, resnet, x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, add_upsample: bool = True,
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, None, groups, eps)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels,
                                                     out_channels)])
                           if add_upsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class VaeAttention(nn.Module):
    """Single-head spatial self-attention with a pre-GroupNorm and biased
    q/k/v/out projections (the VAE mid-block attention). At full size its
    score matrix is too large for the plain path, so it runs the chunked
    online softmax (`ops.attention.chunked_attention`), as in JAX."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(hidden)[:, None]       # [b, 1 head, s, c]
        k = self.to_k(hidden)[:, None]
        v = self.to_v(hidden)[:, None]
        out = self.to_out[0](multi_head_attention(q, k, v)[:, 0])
        return (x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)).contiguous()


class UNetMidBlock2D(nn.Module):
    """resnet -> (attention) -> resnet, no cross attention."""

    def __init__(self, channels: int, add_attention: bool = True,
                 groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, groups, eps)
            for _ in range(2)])
        self.attentions = (nn.ModuleList([VaeAttention(channels, groups, eps)])
                           if add_attention else None)

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)
