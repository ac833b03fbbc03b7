"""The dual CLIP text towers of SDXL's prompt encoder (counterpart of
`faithdiff_tpu/models/clip_text.py`).

SDXL concatenates the penultimate hidden states of the ViT-L/14 text tower
(768) and the OpenCLIP bigG text tower (1280) into the 2048-wide prompt
embeddings, and keeps bigG's projected pooled output (1280). Causal
attention over 77 tokens stays under the flash gate (plain torch, as it is
XLA in the JAX package); LayerNorms accumulate in fp32.

Module names follow transformers' `CLIPTextModel` /
`CLIPTextModelWithProjection` state dicts (`text_model.embeddings.*`,
`text_model.encoder.layers.{i}.self_attn.q_proj`,
`text_model.final_layer_norm`, `text_projection`), so SDXL's
`text_encoder*/model.safetensors` loads strictly once
`text_model.embeddings.position_ids` is dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig
from ..ops.attention import multi_head_attention
from .layers import LayerNorm, quick_gelu

EOS_TOKEN_ID = 49407

_ACTIVATIONS = {
    "quick_gelu": quick_gelu,
    "gelu": F.gelu,                                   # exact erf form
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d, dtype=dtype)
        self.k_proj = nn.Linear(d, d, dtype=dtype)
        self.v_proj = nn.Linear(d, d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, -1).transpose(1, 2)

        out = multi_head_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                   split(self.v_proj(x)), causal=True)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        if cfg.hidden_act not in _ACTIVATIONS:
            raise ValueError(f"CLIP hidden_act {cfg.hidden_act!r}")
        self.act = _ACTIVATIONS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size, dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[None, :s])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype: torch.dtype):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg, dtype)
        self.encoder = CLIPEncoder(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextTower(nn.Module):
    """[B, S] token ids -> (penultimate hidden states, final-LN hidden
    states, pooled). `pooled` is the final-LN state at the first
    `eos_token_id` (position 0 where there is none: `argmax` of the
    match), through `text_projection` when `config.projection_dim` is
    set (SDXL's text_encoder_2)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, dtype)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(
                config.hidden_size, config.projection_dim, bias=False,
                dtype=dtype)

    def forward(self, input_ids: torch.Tensor,
                eos_token_id: int = EOS_TOKEN_ID
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        tm = self.text_model
        input_ids = input_ids.to(device=tm.embeddings.token_embedding.weight.device,
                                 dtype=torch.long)
        x = tm.embeddings(input_ids)
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == len(tm.encoder.layers) - 1:
                penultimate = x
            x = layer(x)
        final = tm.final_layer_norm(x)
        eot = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eot]
        if self.config.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return penultimate, final, pooled


class SDXLTextEncoder(nn.Module):
    """Both towers: (ids_1, ids_2) [B, 77] -> (prompt embeds [B, 77, 2048],
    pooled [B, 1280]) at full width. The negative branch of an empty
    prompt is zeros, which the pipeline makes."""

    def __init__(self, config_1: CLIPTextConfig = CLIPTextConfig.sdxl_text_encoder(),
                 config_2: CLIPTextConfig = CLIPTextConfig.sdxl_text_encoder_2(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_encoder = CLIPTextTower(config_1, dtype)
        self.text_encoder_2 = CLIPTextTower(config_2, dtype)

    def forward(self, input_ids_1: torch.Tensor, input_ids_2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pen1, _, _ = self.text_encoder(input_ids_1)
        pen2, _, pooled2 = self.text_encoder_2(input_ids_2)
        return torch.cat([pen1, pen2], dim=-1), pooled2
