"""MPT decoder of the captioner (counterpart of
`faithdiff_tpu/captioner/mpt.py`): pre-LN blocks with a fused `Wqkv`
projection, ALiBi position biases, an exact-GELU MLP at 4x expansion, and
an lm_head tied to the token embedding. No quantisation, as in JAX.

Module names are the transformers MPT state-dict keys
(`transformer.wte`, `transformer.blocks.{i}.attn.Wqkv`,
`transformer.blocks.{i}.ffn.up_proj`, `transformer.norm_f`). The call
signature matches `LlamaForCausalLM`, so `greedy_generate` drives either
family; `positions` is accepted and unused (ALiBi is relative).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .llama import _masked_attention


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    vocab_size: int = 50432
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    alibi_bias_max: float = 8.0
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "MPTConfig":
        return MPTConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                         max_seq_len=128)


def alibi_slopes(n_heads: int, bias_max: float = 8.0) -> np.ndarray:
    """ALiBi head slopes: 2^(-bias_max * i / n) over the next power of two
    of n_heads, then every other slope when n is not a power of two."""
    n = 2 ** int(np.ceil(np.log2(n_heads)))
    m = np.arange(1, n + 1, dtype=np.float32) * (bias_max / n)
    slopes = 1.0 / np.power(2.0, m)
    if n != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes


@functools.lru_cache(maxsize=None)
def _slopes(n_heads: int, bias_max: float, device: torch.device) -> torch.Tensor:
    """ALiBi slopes kept on the device (no host copy per call)."""
    return torch.from_numpy(alibi_slopes(n_heads, bias_max)).to(device)


class LayerNormNoBias(nn.Module):
    """Two-pass fp32 LayerNorm with a weight and no bias."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


class MPTAttention(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.Wqkv = nn.Linear(cfg.d_model, 3 * cfg.d_model, bias=False, dtype=dtype)
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_model, bias=False, dtype=dtype)

    def forward(self, x, kv_cache=None, cache_index=None, attn_len=None):
        cfg = self.cfg
        b, s, d = x.shape
        heads = cfg.n_heads
        q, k, v = (t.reshape(b, s, heads, -1).transpose(1, 2)
                   for t in self.Wqkv(x).chunk(3, dim=-1))
        slopes = _slopes(heads, cfg.alibi_bias_max, x.device)
        if kv_cache is None or s > 1:
            if kv_cache is not None:
                kv_cache[0][:, :, cache_index:cache_index + s] = k
                kv_cache[1][:, :, cache_index:cache_index + s] = v
            qi = torch.arange(s, device=x.device)[:, None]
            ki = torch.arange(s, device=x.device)[None, :]
            # ALiBi: bias = -slope * (q_pos - k_pos), causal
            bias = -slopes[:, None, None] * (qi - ki).float()
            mask = (ki <= qi)[None, None]
        else:
            ck, cv = kv_cache
            ck[:, :, cache_index:cache_index + 1] = k
            cv[:, :, cache_index:cache_index + 1] = v
            # keys past attn_len are masked; the step reads only [0, attn_len]
            k, v = ck[:, :, :attn_len + 1], cv[:, :, :attn_len + 1]
            ki = torch.arange(attn_len + 1, device=x.device)[None, :]
            bias = -slopes[:, None, None] * (attn_len - ki).float()
            mask = torch.ones_like(ki, dtype=torch.bool)[None, None]
        out = _masked_attention(q, k, v, mask, bias[None])
        return self.out_proj(out.transpose(1, 2).reshape(b, -1, d)), kv_cache


class MPTMLP(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype: torch.dtype):
        super().__init__()
        inner = cfg.expansion_ratio * cfg.d_model
        self.up_proj = nn.Linear(cfg.d_model, inner, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(inner, cfg.d_model, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.gelu(self.up_proj(x)))


class MPTBlock(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype: torch.dtype):
        super().__init__()
        self.norm_1 = LayerNormNoBias(cfg.d_model, cfg.layer_norm_eps)
        self.attn = MPTAttention(cfg, dtype)
        self.norm_2 = LayerNormNoBias(cfg.d_model, cfg.layer_norm_eps)
        self.ffn = MPTMLP(cfg, dtype)

    def forward(self, x, kv_cache=None, cache_index=None, attn_len=None):
        attn_out, kv_cache = self.attn(self.norm_1(x), kv_cache, cache_index, attn_len)
        x = x + attn_out
        return x + self.ffn(self.norm_2(x)), kv_cache


class MPTModel(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype: torch.dtype):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype)
        self.blocks = nn.ModuleList(MPTBlock(cfg, dtype) for _ in range(cfg.n_layers))
        self.norm_f = LayerNormNoBias(cfg.d_model, cfg.layer_norm_eps)


class MPTForCausalLM(nn.Module):
    def __init__(self, config: MPTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.transformer = MPTModel(config, dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte(input_ids)

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        return init_mpt_kv_caches(self.config, batch, max_len, dtype, device)

    def forward(self, inputs_embeds, positions=None, kv_caches=None,
                cache_index=None, attn_len=None):
        del positions  # ALiBi: relative biases only
        tr = self.transformer
        x = inputs_embeds
        for i, block in enumerate(tr.blocks):
            cache_i = kv_caches[i] if kv_caches is not None else None
            x, _ = block(x, cache_i, cache_index, attn_len)
        x = tr.norm_f(x)
        # lm_head tied to wte, in the embedding's dtype
        w = tr.wte.weight
        return torch.matmul(x.to(w.dtype), w.T), kv_caches


def init_mpt_kv_caches(cfg: MPTConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None):
    hd = cfg.d_model // cfg.n_heads
    shape = (batch, cfg.n_heads, max_len, hd)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)]
