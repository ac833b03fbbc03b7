"""Plain PyTorch reference of the DeepSeek-V3 language model (Kimi-VL-A3B's
LM): one full causal forward in fp32 with TF32 off, no kernels, no cache,
no batching. It imports nothing but torch, so a benchmark can keep a copy.

`forward(config, embeds, weight, rows)` takes the config's keys as a
mapping (transformers' DeepseekV3 `config.json` names), the input
embeddings of one sequence [S, hidden] and `weight(name)`, which returns
the parameter `name` as an fp32 tensor: weights are asked for one layer at
a time, in order, so a caller that makes them on demand never holds more
than a layer of them. Names are transformers' DeepseekV3 ones, the routed
experts stacked: `model.layers.{i}.mlp.experts.gate_up_proj` [E, 2F, D]
(gate rows first) and `.down_proj` [E, D, F].

The equations, as published (DeepSeek-V3, arXiv:2412.19437, and
transformers' `modeling_deepseek_v3`): `h = x + MLA(RMSNorm(x))`, `y = h +
FFN(RMSNorm(h))`; MLA with `q = W_q x` (no q LoRA), `[c_kv | k_pe] =
W_kv_a x`, `c_kv` RMS-normed, `[k_nope | v] = W_kv_b c_kv` per head, RoPE
on q_pe and the shared k_pe with the pair (x[2i], x[2i+1]) turned by
position * theta^(-2i/d), a causal softmax at 1/sqrt(nope + rope); the FFN
a SwiGLU MLP below `first_k_dense_replace`, above it sigmoid scores, the
top-k of scores + e_score_correction_bias chosen, their uncorrected scores
normalised and scaled by routed_scaling_factor, plus the shared experts.
Departures: one expert group only (n_group = topk_group = 1).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, ..., d] with the pair (x[2i], x[2i+1]) turned by position *
    theta^(-2i/d)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * inv[None]                   # [S, d/2]
    ang = ang.reshape(ang.shape[:1] + (1,) * (x.ndim - 2) + ang.shape[1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x1 * cos - x2 * sin
    out[..., 1::2] = x2 * cos + x1 * sin
    return out


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def mla(cfg: Mapping, x: torch.Tensor, positions: torch.Tensor,
        weight: Callable[[str], torch.Tensor], p: str) -> torch.Tensor:
    s = x.shape[0]
    h, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rdim, vdim, r = cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ weight(p + "q_proj.weight").T).view(s, h, nope + rdim)
    kv = x @ weight(p + "kv_a_proj_with_mqa.weight").T
    c_kv = rms_norm(kv[:, :r], weight(p + "kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    k_pe = rope(kv[:, r:], positions, cfg["rope_theta"])                 # [S, rope]
    kvb = (c_kv @ weight(p + "kv_b_proj.weight").T).view(s, h, nope + vdim)
    q = torch.cat((q[..., :nope], rope(q[..., nope:], positions, cfg["rope_theta"])), -1)
    k = torch.cat((kvb[..., :nope], k_pe[:, None].expand(s, h, rdim)), -1)
    v = kvb[..., nope:]
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(nope + rdim)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("hst,thd->shd", probs, v).reshape(s, h * vdim)
    return out @ weight(p + "o_proj.weight").T


def moe(cfg: Mapping, x: torch.Tensor, weight: Callable[[str], torch.Tensor],
        p: str, chosen: Optional[torch.Tensor] = None):
    """(the layer's output, its own top-k [S, k]); `chosen` [S, k], where
    given, routes each token to those experts instead of its own top-k."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(x @ weight(p + "gate.weight").T)             # [S, E]
    own = torch.topk(scores + weight(p + "gate.e_score_correction_bias"), k,
                     dim=-1).indices
    chosen = own if chosen is None else chosen.to(own.device)
    w = scores.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    w = w * cfg["routed_scaling_factor"]
    out = swiglu(x, weight(p + "shared_experts.gate_proj.weight"),
                 weight(p + "shared_experts.up_proj.weight"),
                 weight(p + "shared_experts.down_proj.weight"))
    gate_up, down = weight(p + "experts.gate_up_proj"), weight(p + "experts.down_proj")
    f = cfg["moe_intermediate_size"]
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], gate_up[e, :f], gate_up[e, f:], down[e])
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out, own


@torch.no_grad()
def forward(cfg: Mapping, embeds: torch.Tensor, weight: Callable[[str], torch.Tensor],
            rows: Optional[Sequence[int]] = None, routes: Optional[Mapping] = None,
            seen: Optional[dict] = None) -> torch.Tensor:
    """Logits [len(rows), vocab] (every position without `rows`) of the
    causal forward over `embeds` [S, hidden], positions 0 .. S-1.

    `routes` {layer: [S, k] expert ids} teacher-forces the routing as the
    tokens are: each MoE layer sends each token to those experts (weighted
    by its own normalised scores of them) instead of its own top-k, so
    that a comparison with a program measures the arithmetic and not the
    near-ties that rounding flips. `seen`, a dict, receives each MoE
    layer's own top-k [S, k] by layer index."""
    if cfg.get("q_lora_rank") is not None or cfg.get("n_group", 1) != 1:
        raise NotImplementedError("q LoRA and expert groups are not in this reference")
    with no_tf32():
        x = embeds.float()
        positions = torch.arange(x.shape[0], device=x.device)
        eps = cfg["rms_norm_eps"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}."
            x = x + mla(cfg, rms_norm(x, weight(p + "input_layernorm.weight"), eps),
                        positions, weight, p + "self_attn.")
            hn = rms_norm(x, weight(p + "post_attention_layernorm.weight"), eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + swiglu(hn, weight(p + "mlp.gate_proj.weight"),
                               weight(p + "mlp.up_proj.weight"),
                               weight(p + "mlp.down_proj.weight"))
            else:
                y, own = moe(cfg, hn, weight, p + "mlp.", (routes or {}).get(i))
                x = x + y
                if seen is not None:
                    seen[i] = own
        if rows is not None:
            x = x[torch.as_tensor(list(rows), device=x.device)]
        x = rms_norm(x, weight("model.norm.weight"), eps)
        return x @ weight("lm_head.weight").T


def parameter_shapes(cfg: Mapping) -> dict:
    """{name: shape} of every parameter the forward asks `weight` for, in
    the order it asks, and of the token embedding."""
    d, h, e = cfg["hidden_size"], cfg["num_attention_heads"], cfg["n_routed_experts"]
    nope, rdim, vdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r, f = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    shared = cfg["n_shared_experts"] * f
    out = {"model.embed_tokens.weight": (cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({p + "input_layernorm.weight": (d,),
                    p + "self_attn.q_proj.weight": (h * (nope + rdim), d),
                    p + "self_attn.kv_a_proj_with_mqa.weight": (r + rdim, d),
                    p + "self_attn.kv_a_layernorm.weight": (r,),
                    p + "self_attn.kv_b_proj.weight": (h * (nope + vdim), r),
                    p + "self_attn.o_proj.weight": (d, h * vdim),
                    p + "post_attention_layernorm.weight": (d,)})
        if i < cfg["first_k_dense_replace"]:
            w = cfg["intermediate_size"]
            out.update({p + "mlp.gate_proj.weight": (w, d), p + "mlp.up_proj.weight": (w, d),
                        p + "mlp.down_proj.weight": (d, w)})
        else:
            out.update({p + "mlp.gate.weight": (e, d),
                        p + "mlp.gate.e_score_correction_bias": (e,),
                        p + "mlp.shared_experts.gate_proj.weight": (shared, d),
                        p + "mlp.shared_experts.up_proj.weight": (shared, d),
                        p + "mlp.shared_experts.down_proj.weight": (d, shared),
                        p + "mlp.experts.gate_up_proj": (e, 2 * f, d),
                        p + "mlp.experts.down_proj": (e, d, f)})
    out.update({"model.norm.weight": (d,), "lm_head.weight": (cfg["vocab_size"], d)})
    return out
