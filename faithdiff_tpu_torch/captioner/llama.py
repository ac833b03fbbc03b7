"""LLaMA decoder of the LLaVA captioner (counterpart of
`faithdiff_tpu/captioner/llama.py`): RMSNorm, split-half rotary
embeddings, SwiGLU MLP, causal attention with grouped KV heads and an
optional sliding window, weight-only int8 / NF4 projections, and
KV-cache generation.

Module names are the transformers `LlamaForCausalLM` state-dict keys
(`model.embed_tokens`, `model.layers.{i}.self_attn.q_proj`,
`model.layers.{i}.mlp.gate_proj`, `model.norm`, `lm_head`). Linear and
embedding weights are held in the compute dtype (the JAX package holds
them in fp32 and casts at use, which rounds the same way); norms stay fp32.
Under `quant="nf4"` every projection but `lm_head` is an `NF4Dense`, whose
matmul is the hand-written kernel on the card.

Generation is a prefill pass that writes the KV cache, then a Python loop of
one-token decode steps over the preallocated cache, updated in place; the
loop stops early once every sample is done.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..utils.quantize import (Int8Weight, NF4Weight, int8_matmul, nf4_matmul,
                              quantize_int8, quantize_nf4)

_MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 5120
    intermediate_size: int = 13824
    num_hidden_layers: int = 40
    num_attention_heads: int = 40
    num_key_value_heads: int = 40
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # weight-only quantised projections: "int8" (the reference's load_8bit)
    # or "nf4" (load_4bit)
    quant: str = ""           # "" | "int8" | "nf4"
    # Mistral-family sliding-window attention (None = full causal)
    sliding_window: Optional[int] = None

    @staticmethod
    def llava_13b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=4096, intermediate_size=14336,
                           num_hidden_layers=32, num_attention_heads=32,
                           num_key_value_heads=8,
                           max_position_embeddings=32768,
                           sliding_window=4096)

    @staticmethod
    def tiny_mistral() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128, sliding_window=8)

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=4,
                           max_position_embeddings=128)


class Int8Dense(nn.Module):
    """Weight-only int8 linear: `values` int8 [in, out], `scales` f32 [out]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("values", torch.zeros((in_features, out_features),
                                                   dtype=torch.int8))
        self.register_buffer("scales", torch.ones(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, Int8Weight(self.values, self.scales))


class NF4Dense(nn.Module):
    """Weight-only NF4 linear in the half-row layout: `packed` uint8
    [out, in/2], `absmax` f32 [out, in/64]. Computes in x's dtype."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("packed", torch.zeros((out_features, in_features // 2),
                                                   dtype=torch.uint8))
        self.register_buffer("absmax", torch.ones((out_features, in_features // 64)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = NF4Weight(self.packed, self.absmax, (self.in_features, self.out_features))
        return nf4_matmul(x, q)


def _proj(quant: str, in_f: int, out_f: int, dtype: torch.dtype) -> nn.Module:
    if quant == "int8":
        return Int8Dense(in_f, out_f)
    if quant == "nf4":
        return NF4Dense(in_f, out_f)
    if quant:
        raise ValueError(f"unknown quant {quant!r}")
    return nn.Linear(in_f, out_f, bias=False, dtype=dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """Rotary frequencies (fp32, from numpy as in JAX), kept on the device:
    a host-to-device copy in every call would stall the host on the
    stream in each layer of each decode step."""
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    return torch.from_numpy(inv).to(device)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """Split-half rotary embedding. x: [B, H, S, D]; positions: [B, S]."""
    freqs = positions.float()[:, :, None] * _inv_freq(x.shape[-1], theta, x.device)
    cos = torch.cos(freqs)[:, None]          # [B, 1, S, D/2]
    sin = torch.sin(freqs)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _masked_attention(q, k, v, mask, bias=None):
    """Attention with a boolean mask (True = attend) and an optional fp32
    logit bias: fp32 logits and softmax, masked logits at -1e30, probs cast
    to v's dtype."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * float(scale)
    if bias is not None:
        logits = logits + bias
    logits = torch.where(mask, logits, torch.full_like(logits, _MASKED))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, heads, kv_heads = (cfg.hidden_size, cfg.num_attention_heads,
                              cfg.num_key_value_heads)
        hd = d // heads
        self.q_proj = _proj(cfg.quant, d, heads * hd, dtype)
        self.k_proj = _proj(cfg.quant, d, kv_heads * hd, dtype)
        self.v_proj = _proj(cfg.quant, d, kv_heads * hd, dtype)
        self.o_proj = _proj(cfg.quant, heads * hd, d, dtype)

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                attn_len=None, pad_len=None):
        """`kv_cache`: (k, v) [B, KVH, MAX, D], written in place at
        `cache_index`. `pad_len`: optional [B] left-pad counts; keys at
        cache positions < pad_len[b] are masked out. A query length > 1 is
        the causal prefill; 1 is a decode step attending over the cache up
        to `attn_len`."""
        cfg = self.cfg
        heads, kv_heads = cfg.num_attention_heads, cfg.num_key_value_heads
        b, s, _ = x.shape

        def split(t, n):
            return t.reshape(b, s, n, -1).transpose(1, 2)

        q = rotary_embed(split(self.q_proj(x), heads), positions, cfg.rope_theta)
        k = rotary_embed(split(self.k_proj(x), kv_heads), positions, cfg.rope_theta)
        v = split(self.v_proj(x), kv_heads)
        rep = heads // kv_heads

        if kv_cache is None or s > 1:
            if kv_cache is not None:
                kv_cache[0][:, :, cache_index:cache_index + s] = k
                kv_cache[1][:, :, cache_index:cache_index + s] = v
            if rep > 1:
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            if cfg.sliding_window is not None or pad_len is not None:
                qi = torch.arange(s, device=x.device)[:, None]
                ki = torch.arange(s, device=x.device)[None, :]
                mask = ki <= qi
                if cfg.sliding_window is not None:
                    mask = mask & (ki > qi - cfg.sliding_window)
                mask = mask[None, None]                          # [1,1,Q,K]
                if pad_len is not None:
                    mask = mask & (ki[None, None] >= pad_len[:, None, None, None])
                out = _masked_attention(q, k, v, mask)
            else:
                out = multi_head_attention(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True)
        else:
            ck, cv = kv_cache
            ck[:, :, cache_index:cache_index + 1] = k
            cv[:, :, cache_index:cache_index + 1] = v
            # keys past attn_len are masked in the static cache; they carry
            # exactly zero weight, so the step reads only [0, attn_len]
            ck, cv = ck[:, :, :attn_len + 1], cv[:, :, :attn_len + 1]
            if rep > 1:
                ck = ck.repeat_interleave(rep, dim=1)
                cv = cv.repeat_interleave(rep, dim=1)
            ki = torch.arange(attn_len + 1, device=x.device)[None, None, None]
            mask = torch.ones_like(ki, dtype=torch.bool)
            if cfg.sliding_window is not None:
                mask = mask & (ki > attn_len - cfg.sliding_window)
            if pad_len is not None:
                mask = mask & (ki >= pad_len[:, None, None, None])
            out = _masked_attention(q, ck, cv, mask)

        out = out.transpose(1, 2).reshape(b, s, -1)
        return self.o_proj(out), kv_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _proj(cfg.quant, d, f, dtype)
        self.up_proj = _proj(cfg.quant, d, f, dtype)
        self.down_proj = _proj(cfg.quant, f, d, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, dtype)

    def forward(self, x, positions, kv_cache=None, cache_index=None,
                attn_len=None, pad_len=None):
        attn_out, kv_cache = self.self_attn(self.input_layernorm(x), positions,
                                            kv_cache, cache_index, attn_len, pad_len)
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x)), kv_cache


class LlamaModel(nn.Module):
    """Backbone taking input embeddings (LLaVA splices the image features
    into the token embeddings before it)."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(LlamaLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds, positions, kv_caches=None,
                cache_index=None, attn_len=None, pad_len=None):
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            cache_i = kv_caches[i] if kv_caches is not None else None
            x, _ = layer(x, positions, cache_i, cache_index, attn_len, pad_len)
        return self.norm(x), kv_caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, config: LlamaConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.model = LlamaModel(config, dtype)
        # transformers' load_in_4bit keeps lm_head at full precision;
        # int8 quantises it like the other projections
        head_quant = "" if config.quant == "nf4" else config.quant
        self.lm_head = _proj(head_quant, config.hidden_size, config.vocab_size, dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(input_ids)

    def forward(self, inputs_embeds, positions, kv_caches=None,
                cache_index=None, attn_len=None, pad_len=None):
        x, caches = self.model(inputs_embeds, positions, kv_caches,
                               cache_index, attn_len, pad_len)
        return self.lm_head(x), caches


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (batch, cfg.num_key_value_heads, max_len, hd)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]


class GenerateResult(NamedTuple):
    tokens: torch.Tensor     # [B, max_new_tokens] int32 ids (eos-padded)
    lengths: torch.Tensor    # [B] int32 count of valid tokens


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter of `_sample_tokens`: keep the logits at or above the
    cutoff, the sorted logit at index sum(cumsum(softmax(sorted)) < top_p);
    the rest become -1e30. Runs in the logits' dtype."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits < cutoff, torch.full_like(logits, _MASKED), logits)


def _sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                   temperature: float, top_p: float) -> torch.Tensor:
    """Greedy (temperature <= 0) or top-p nucleus sampling from a
    `torch.Generator` (the reference samples at 0.2 / 0.7)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _keyword_check(out, col: int, skip, done, stop_len, stop_seqs):
    """KeywordsStoppingCriteria (`llava/mm_utils.py:216-247`): samples whose
    tokens ending at `col` equal a stop sequence (int32 tensors on the
    device) are done, and their length stops before the keyword. `skip`:
    samples done before this step."""
    for seq in stop_seqs:
        start = col + 1 - len(seq)
        if start < 0:
            continue
        hit = (out[:, start:col + 1] == seq).all(dim=1) & ~skip
        stop_len = torch.where(hit, torch.clamp(stop_len, max=start), stop_len)
        done = done | hit
    return done, stop_len


@torch.no_grad()
def greedy_generate(
    model: nn.Module,
    prompt_embeds: torch.Tensor,           # [B, S, D] multimodal prompt
    max_new_tokens: int,
    eos_token_id: int = 2,
    temperature: float = 0.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    stop_sequences: Optional[Sequence[Sequence[int]]] = None,
    pad_len: Optional[torch.Tensor] = None,
) -> GenerateResult:
    """Prefill + autoregressive decode over a static KV cache.

    temperature <= 0 is greedy; otherwise top-p sampling from `generator`.
    `stop_sequences`: a sample stops when its newest tokens match one; the
    keyword is left out of `lengths`. `pad_len`: optional [B] left-pad
    counts of variable-length prompts (LLaMA family only): padded positions
    are masked out of attention and of the rotary positions. Finished
    samples are padded with eos; the loop ends when all are done."""
    cfg = model.config
    b, s, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    is_mpt = hasattr(cfg, "d_model")
    if pad_len is not None:
        if is_mpt:
            raise ValueError("pad_len (batched anyres) is a LLaMA-family feature")
        pad_len = torch.as_tensor(pad_len, dtype=torch.int32, device=dev)
    stop_seqs = [torch.tensor([int(t) for t in q], dtype=torch.int32, device=dev)
                 for q in (stop_sequences or ()) if len(q)]
    max_len = s + max_new_tokens
    if is_mpt:
        from .mpt import init_mpt_kv_caches

        caches = init_mpt_kv_caches(cfg, b, max_len, prompt_embeds.dtype, dev)
    else:
        caches = init_kv_caches(cfg, b, max_len, prompt_embeds.dtype, dev)
    arange = torch.arange(s, device=dev)[None]
    extra = {}
    if pad_len is not None:
        positions = torch.clamp(arange - pad_len[:, None], min=0)
        extra["pad_len"] = pad_len
    else:
        positions = arange.expand(b, s)
    logits, caches = model(prompt_embeds, positions, caches, 0, s - 1, **extra)

    tok = _sample_tokens(logits[:, -1, :], generator, temperature, top_p)
    done = tok == eos_token_id
    out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.int32, device=dev)
    out[:, 0] = tok
    lengths = torch.ones((b,), dtype=torch.int32, device=dev)
    stop_len = torch.full((b,), max_new_tokens + 1, dtype=torch.int32, device=dev)
    if stop_seqs:
        done, stop_len = _keyword_check(out, 0, torch.zeros_like(done), done,
                                        stop_len, stop_seqs)
    i = 0
    while i < max_new_tokens - 1 and not bool(done.all()):
        done_prev = done
        pos = torch.full((b, 1), s + i, dtype=torch.int64, device=dev)
        if pad_len is not None:
            pos = pos - pad_len[:, None]
        logits, caches = model(model.embed(tok[:, None].long()), pos, caches,
                               s + i, s + i, **extra)
        nxt = _sample_tokens(logits[:, -1, :], generator, temperature, top_p)
        nxt = torch.where(done_prev, torch.full_like(nxt, eos_token_id), nxt)
        done = done_prev | (nxt == eos_token_id)
        out[:, i + 1] = nxt
        if stop_seqs:
            done, stop_len = _keyword_check(out, i + 1, done_prev, done,
                                            stop_len, stop_seqs)
        lengths = lengths + (~done).to(torch.int32)
        tok = nxt
        i += 1
    if stop_seqs:
        lengths = torch.minimum(lengths, stop_len)
    return GenerateResult(tokens=out, lengths=lengths)


_QUANT_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
                     "gate_proj", "up_proj", "down_proj", "lm_head")


@torch.no_grad()
def quantize_llama_params(state_dict: Dict[str, torch.Tensor],
                          mode: str = "int8") -> Dict[str, torch.Tensor]:
    """Full-precision state dict -> the `quant="int8"` / `quant="nf4"`
    model's state dict. Each projection `<p>.weight` [out, in] becomes
    `<p>.values` int8 [in, out] + `<p>.scales`, or `<p>.packed` uint8
    [out, in/2] + `<p>.absmax` (half-row NF4); under nf4 `lm_head` stays."""
    if mode not in ("int8", "nf4"):
        raise ValueError(f"unknown quantisation mode {mode!r}")
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        name = prefix.rpartition(".")[2]
        if leaf != "weight" or name not in _QUANT_PROJ_NAMES or (
                mode == "nf4" and name == "lm_head"):
            out[key] = value
            continue
        if mode == "nf4":
            q = quantize_nf4(value.T)
            out[prefix + ".packed"], out[prefix + ".absmax"] = q.packed, q.absmax
        else:
            q = quantize_int8(value.T)
            out[prefix + ".values"], out[prefix + ".scales"] = q.values, q.scales
    return out


@torch.no_grad()
def random_init_quantized_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights for every `NF4Dense` / `Int8Dense` of `model`: each
    projection is drawn N(0, 1/in) in bf16 on the model's device and
    quantised at once, so the full-precision model is never held."""
    for m in model.modules():
        if not isinstance(m, (NF4Dense, Int8Dense)):
            continue
        buf = m.packed if isinstance(m, NF4Dense) else m.values
        w = torch.empty((m.out_features, m.in_features), dtype=torch.bfloat16,
                        device=buf.device)
        w.normal_(0.0, m.in_features ** -0.5, generator=generator)
        if isinstance(m, NF4Dense):
            q = quantize_nf4(w.T)
            m.packed.copy_(q.packed)
            m.absmax.copy_(q.absmax)
        else:
            q = quantize_int8(w.T)
            m.values.copy_(q.values)
            m.scales.copy_(q.scales)
        del w, q
