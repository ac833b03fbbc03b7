"""Plain PyTorch reference of the captioner's other networks: LLaVA-1.5's
CLIP ViT-L/14-336 vision tower (hidden layer -2, CLS dropped) with its
mlp2x_gelu projector, and SDXL's two CLIP text towers (ViT-L/14's and
OpenCLIP bigG's: the penultimate hidden states concatenated, bigG's
projected pooled output at the first end-of-text token).

Written again in fp32 with stock operations (`F.layer_norm`, matrix
products, a softmax), no kernel of the port; parameter names are
transformers' `CLIPVisionModel` / `CLIPTextModel(WithProjection)` ones and
LLaVA's `mm_projector` (`0`, `2`), as the port's, so one state dict loads
into both. Departures from the published models: none in the mathematics;
the vision tower has no `post_layernorm` (layer -2 never reaches it).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

EOS_TOKEN_ID = 49407
_ACT = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x), "gelu": F.gelu}


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, d: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        b, s, d = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, -1).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // self.heads)
        if self.causal:
            mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~mask, float("-inf"))
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class MLP(nn.Module):
    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.act = _ACT[act]
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Mapping, causal: bool):
        super().__init__()
        d = cfg["hidden_size"]
        self.layer_norm1 = LayerNorm(d, cfg["layer_norm_eps"])
        self.self_attn = Attention(d, cfg["num_attention_heads"], causal)
        self.layer_norm2 = LayerNorm(d, cfg["layer_norm_eps"])
        self.mlp = MLP(d, cfg["intermediate_size"], cfg["hidden_act"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, cfg: Mapping, causal: bool):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg, causal)
                                    for _ in range(cfg["num_hidden_layers"]))


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        d, p = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, p, p, bias=False)
        self.position_embedding = nn.Embedding((cfg["image_size"] // p) ** 2 + 1, d)

    def forward(self, pixels_nhwc):
        patches = self.patch_embedding(pixels_nhwc.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class VisionModel(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])
        self.encoder = Encoder(cfg, causal=False)


class VisionTower(nn.Module):
    """NHWC CLIP-normalised pixels [B, S, S, 3] -> the patch features of
    hidden layer `select_layer` [B, patches, hidden]."""

    def __init__(self, cfg: Mapping, select_layer: int = -2):
        super().__init__()
        self.select_layer = select_layer
        self.vision_model = VisionModel(cfg)

    def forward(self, pixels):
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixels.float()))
        layers = vm.encoder.layers
        for layer in layers[:len(layers) + self.select_layer + 1]:
            x = layer(x)
        return x[:, 1:]


class Projector(nn.Sequential):
    """mlp2x_gelu: Linear, exact GELU, Linear."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, out_dim), nn.GELU(), nn.Linear(out_dim, out_dim))


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                               cfg["hidden_size"])

    def forward(self, ids):
        return self.token_embedding(ids) + self.position_embedding.weight[None, :ids.shape[1]]


class TextModel(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg, causal=True)
        self.final_layer_norm = LayerNorm(cfg["hidden_size"], cfg["layer_norm_eps"])


class TextTower(nn.Module):
    """[B, 77] ids -> (penultimate hidden states, pooled): the final-LN
    state at the first end-of-text token, projected where the config has a
    projection."""

    def __init__(self, cfg: Mapping):
        super().__init__()
        self.text_model = TextModel(cfg)
        if cfg.get("projection_dim"):
            self.text_projection = nn.Linear(cfg["hidden_size"], cfg["projection_dim"],
                                             bias=False)

    def forward(self, ids):
        tm = self.text_model
        x = tm.embeddings(ids)
        for layer in tm.encoder.layers[:-1]:
            x = layer(x)
        penultimate = x
        final = tm.final_layer_norm(tm.encoder.layers[-1](x))
        eot = (ids == EOS_TOKEN_ID).int().argmax(dim=-1)
        pooled = final[torch.arange(ids.shape[0], device=ids.device), eot]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return penultimate, pooled


class TextEncoders(nn.Module):
    """SDXL's prompt encoder: (ids_1, ids_2) -> (embeds [B, 77, 2048],
    pooled [B, 1280])."""

    def __init__(self, cfg_1: Mapping, cfg_2: Mapping):
        super().__init__()
        self.text_encoder = TextTower(cfg_1)
        self.text_encoder_2 = TextTower(cfg_2)

    def forward(self, ids_1, ids_2):
        pen_1, _ = self.text_encoder(ids_1)
        pen_2, pooled = self.text_encoder_2(ids_2)
        return torch.cat([pen_1, pen_2], dim=-1), pooled


def build_captioner(config: dict, device="cpu") -> dict:
    """{"vision", "projector", "text_encoders"}: the fp32 networks of a
    configuration's `captioner` block, on `device`."""
    cap = config["captioner"]
    with torch.device(device):
        return {"vision": VisionTower(cap["vision"], cap["select_layer"]),
                "projector": Projector(cap["vision"]["hidden_size"], config["hidden_size"]),
                "text_encoders": TextEncoders(*cap["text_encoders"])}
