"""Plain PyTorch reference of the restore path's three networks: the SDXL
UNet with the FaithDiff fusion (condition embedding, information
transformer), the SDXL AutoencoderKL and the FaithDiff denoise encoder.

A frozen copy of the plain code paths of the port's `models/` package,
written again in fp32 with stock operations only: `F.group_norm`,
`F.layer_norm`, matrix products and a softmax; no kernel of the port,
no cache, no batching across tiles. Parameter names are diffusers' /
FaithDiff.bin's, so one state dict loads into the port and into this copy.
Attention runs in blocks of query rows so that a 49,152-token VAE
attention fits the card; the blocks change no arithmetic.

Departures from the published models, all the port's too: none in the
mathematics. The attention that the published information transformer
runs over its batch axis (`nn.MultiheadAttention` with
`batch_first=False`) mixes each tile's CFG pair per pixel, as the port's.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# score elements one attention block may hold (1 GiB of fp32)
_SCORE_BLOCK = 1 << 28


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [..., S, D] in fp32, in blocks of query
    rows of at most `_SCORE_BLOCK` score elements."""
    lead = q.shape[:-2]
    sq, sk = q.shape[-2], k.shape[-2]
    planes = math.prod(lead) if lead else 1
    rows = max(1, min(sq, _SCORE_BLOCK // max(1, planes * sk)))
    out = []
    for s in range(0, sq, rows):
        logits = torch.matmul(q[..., s:s + rows, :], k.transpose(-1, -2)) * scale
        out.append(torch.matmul(torch.softmax(logits, dim=-1), v))
    return torch.cat(out, dim=-2)


class GroupNorm(nn.Module):
    """GroupNorm of (x + add), optional SiLU after the affine."""

    def __init__(self, groups: int, channels: int, eps: float,
                 act: Optional[str] = None):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, add=None):
        if add is not None:
            x = x + add[:, :, None, None]
        y = F.group_norm(x, self.groups, self.weight, self.bias, self.eps)
        return F.silu(y) if self.act == "silu" else y


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                       shift: float) -> torch.Tensor:
    """diffusers `get_timestep_embedding` (max period 10000)."""
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(half, dtype=torch.float32,
                                               device=t.device) / (half - shift)
    emb = torch.exp(exponent)[None, :] * t.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, "silu")
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb is not None else None
        self.norm2 = GroupNorm(groups, cout, eps, "silu")
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        add = None
        if temb is not None and self.time_emb_proj is not None:
            add = self.time_emb_proj(F.silu(temb))
        h = self.conv2(self.norm2(h, add))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, cin: int, cout: int, vae: bool = False):
        super().__init__()
        self.vae = vae
        self.conv = nn.Conv2d(cin, cout, 3, stride=2, padding=0 if vae else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.vae else x)


class Upsample2D(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x, size=None):
        if size is None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        else:
            x = F.interpolate(x, size=tuple(size), mode="nearest")
        return self.conv(x)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        kv = cross_dim or dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(kv, inner, bias=False)
        self.to_v = nn.Linear(kv, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape

        def heads(t):
            return t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        out = attention(heads(self.to_q(x)), heads(self.to_k(context)),
                        heads(self.to_v(context)), self.dim_head ** -0.5)
        return self.to_out[0](out.transpose(1, 2).reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, heads: int, depth: int, cross_dim: int,
                 groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads, cross_dim)
            for _ in range(depth)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        hidden = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        hidden = self.proj_out(hidden)
        return x + hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)


class DownBlock(nn.Module):
    """DownBlock2D, or CrossAttnDownBlock2D when `heads` is given."""

    def __init__(self, cin, cout, temb, layers, downsample, groups, eps,
                 heads=None, depth=0, cross_dim=0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, temb, groups, eps)
            for i in range(layers)])
        if heads is not None:
            self.attentions = nn.ModuleList([
                Transformer2DModel(cout, heads, depth, cross_dim, groups)
                for _ in range(layers)])
        else:
            self.attentions = None
        self.downsamplers = (nn.ModuleList([Downsample2D(cout, cout)])
                             if downsample else None)

    def forward(self, x, temb, context):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class UpBlock(nn.Module):
    """UpBlock2D, or CrossAttnUpBlock2D when `heads` is given."""

    def __init__(self, prev, cout, skips: Sequence[int], temb, upsample, groups,
                 eps, heads=None, depth=0, cross_dim=0):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev if i == 0 else cout) + s, cout, temb, groups, eps)
            for i, s in enumerate(skips)])
        if heads is not None:
            self.attentions = nn.ModuleList([
                Transformer2DModel(cout, heads, depth, cross_dim, groups)
                for _ in skips])
        else:
            self.attentions = None
        self.upsamplers = (nn.ModuleList([Upsample2D(cout, cout)])
                           if upsample else None)

    def forward(self, x, res: List[torch.Tensor], temb, context, size=None):
        res = list(res)
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
        return x


class MidBlockCrossAttn(nn.Module):
    def __init__(self, ch, temb, heads, depth, cross_dim, groups, eps):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, temb, groups, eps)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(ch, heads, depth, cross_dim, groups)])

    def forward(self, x, temb, context):
        x = self.attentions[0](self.resnets[0](x, temb), context)
        return self.resnets[1](x, temb)


class ConditionEmbedding(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm_in = GroupNorm(32, cin, 1e-6)
        self.conv_in = nn.Conv2d(cin, cin, 3, padding=1)
        self.conv_out = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return self.conv_out(F.silu(self.conv_in(self.norm_in(x))))


class MultiheadAttention(nn.Module):
    """`nn.MultiheadAttention`'s parameters over [..., seq, d] tokens."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        *lead, s, d = x.shape
        hd = d // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)

        def heads(t):
            return t.reshape(*lead, s, self.heads, hd).transpose(-3, -2)

        out = attention(heads(q), heads(k), heads(v), hd ** -0.5)
        return self.out_proj(out.transpose(-3, -2).reshape(*lead, s, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(d, heads)
        self.ln_1 = LayerNorm(d)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(d, 2 * d),
                                  "c_proj": nn.Linear(2 * d, d)})
        self.ln_2 = LayerNorm(d)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = self.mlp["c_fc"](self.ln_2(x))
        return x + self.mlp["c_proj"](h * torch.sigmoid(1.702 * h))


class UNet(nn.Module):
    """SDXL UNet with the FaithDiff fusion after `conv_in`. `cfg` is the
    configuration file's "unet" object."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        temb = ch[0] * 4
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        xdim = cfg["cross_attention_dim"]
        heads = cfg["attention_head_dim"]          # diffusers: head COUNT
        depth = cfg["transformer_layers_per_block"]
        layers = cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(
            cfg["projection_class_embeddings_input_dim"], temb)
        self.condition_embedding = ConditionEmbedding(cfg["condition_channels"], ch[0])
        self.information_transformer_layes = nn.ModuleList([
            ResidualAttentionBlock(cfg["info_transformer_dim"],
                                   cfg["info_transformer_heads"])
            for _ in range(cfg["info_transformer_layers"])])
        self.spatial_ch_projs = nn.Linear(cfg["info_transformer_dim"], ch[0])

        n = len(ch)
        self.down_blocks = nn.ModuleList()
        skips, cin = [ch[0]], ch[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            final = i == n - 1
            attn = dict(heads=heads[i], depth=depth[i], cross_dim=xdim) \
                if kind == "CrossAttnDownBlock2D" else {}
            self.down_blocks.append(DownBlock(cin, ch[i], temb, layers,
                                              not final, groups, eps, **attn))
            skips += [ch[i]] * layers + ([] if final else [ch[i]])
            cin = ch[i]
        self.mid_block = MidBlockCrossAttn(ch[-1], temb, heads[-1], depth[-1],
                                           xdim, groups, eps)
        self.up_blocks = nn.ModuleList()
        rev, prev = list(reversed(ch)), ch[-1]
        for i, kind in enumerate(cfg["up_block_types"]):
            final = i == len(cfg["up_block_types"]) - 1
            block_skips = [skips.pop() for _ in range(layers + 1)]
            r = n - 1 - i
            attn = dict(heads=heads[r], depth=depth[r], cross_dim=xdim) \
                if kind == "CrossAttnUpBlock2D" else {}
            self.up_blocks.append(UpBlock(prev, rev[i], block_skips, temb,
                                          not final, groups, eps, **attn))
            prev = rev[i]
        self.conv_norm_out = GroupNorm(groups, ch[0], eps, "silu")
        self.conv_out = nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def fusion(self, sample, cond, group: int):
        """The information transformer over [sample, cond] tokens; attention
        mixes each group of `group` batch entries per pixel."""
        tokens = torch.cat([sample, cond], dim=1)
        b, c, h, w = sample.shape
        tokens = tokens.reshape(b // group, group, 2 * c, h * w).permute(0, 3, 1, 2)
        for layer in self.information_transformer_layes:
            tokens = layer(tokens)
        feat = self.spatial_ch_projs(tokens)
        return feat.permute(0, 2, 3, 1).reshape(b, -1, h, w)

    def forward(self, sample, timestep, context, text_embeds, time_ids,
                lq_features, add_sample: bool = True, group: int = 2):
        cfg = self.cfg
        b = sample.shape[0]
        t = torch.as_tensor(timestep, device=sample.device, dtype=torch.float32)
        t = t.expand(b) if t.ndim == 0 else t
        flip, shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        emb = self.time_embedding(timestep_embedding(
            t, cfg["block_out_channels"][0], flip, shift))
        time_embeds = timestep_embedding(time_ids.reshape(-1),
                                         cfg["addition_time_embed_dim"],
                                         flip, shift).reshape(b, -1)
        emb = emb + self.add_embedding(torch.cat([text_embeds, time_embeds], -1))

        sample = self.conv_in(sample)
        feat = self.fusion(sample, self.condition_embedding(lq_features), group)
        sample = sample + feat if add_sample else feat

        res = [sample]
        for block in self.down_blocks:
            sample, r = block(sample, emb, context)
            res += r
        sample = self.mid_block(sample, emb, context)
        n = cfg["layers_per_block"] + 1
        for block in self.up_blocks:
            r, res = res[-n:], res[:-n]
            sample = block(sample, r, emb, context, res[-1].shape[2:] if res else None)
        return self.conv_out(self.conv_norm_out(sample))


class VaeAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = attention(self.to_q(hidden), self.to_k(hidden),
                        self.to_v(hidden), c ** -0.5)
        return x + self.to_out[0](out).reshape(b, h, w, c).permute(0, 3, 1, 2)


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, add_attention: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, groups, 1e-6)
                                      for _ in range(2)])
        self.attentions = (nn.ModuleList([VaeAttention(ch, groups)])
                           if add_attention else None)

    def forward(self, x):
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class EncoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, downsample, groups):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, None, groups, 1e-6)
            for i in range(layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(cout, cout, vae=True)])
                             if downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.downsamplers[0](x) if self.downsamplers is not None else x


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, upsample, groups):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if i == 0 else cout, cout, None, groups, 1e-6)
            for i in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout, cout)])
                           if upsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.upsamplers[0](x) if self.upsamplers is not None else x


class Encoder(nn.Module):
    """The VAE encoder; `with_head=False` is the denoise encoder (the trunk
    up to the mid block)."""

    def __init__(self, cfg: dict, with_head: bool = True):
        super().__init__()
        ch, groups = cfg["block_out_channels"], cfg["norm_num_groups"]
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            self.down_blocks.append(EncoderBlock(cin, cout, cfg["layers_per_block"],
                                                 i < len(ch) - 1, groups))
            cin = cout
        self.mid_block = MidBlock(cin, groups, cfg.get("mid_block_add_attention", True))
        self.with_head = with_head
        if with_head:
            self.conv_norm_out = GroupNorm(groups, cin, 1e-6, "silu")
            self.conv_out = nn.Conv2d(cin, 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x)) if self.with_head else x


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        rev, groups = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], groups)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, cout in enumerate(rev):
            self.up_blocks.append(DecoderBlock(cin, cout, cfg["layers_per_block"] + 1,
                                               i < len(rev) - 1, groups))
            cin = cout
        self.conv_norm_out = GroupNorm(groups, cin, 1e-6, "silu")
        self.conv_out = nn.Conv2d(cin, cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        lc = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def build_models(config: dict, device="cpu") -> dict:
    """{"unet", "vae", "denoise_encoder"} of the configuration file's
    sizes, fp32, on `device` (the meta device gives shapes without memory)."""
    with torch.device(device):
        models = {"unet": UNet(config["unet"]),
                  "vae": AutoencoderKL(config["vae"]),
                  "denoise_encoder": Encoder(config["denoise_encoder"],
                                             with_head=False)}
    for m in models.values():
        m.eval().requires_grad_(False)
    return models
