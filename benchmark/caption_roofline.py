"""The work of the captioner's language model, counted from the
configuration's shapes (its top-level DeepSeek-V3 keys) for one caption of
`prompt` tokens and `new` new tokens at batch 1: the least time of the MoE
layers and of the MLA prefill's wide flash attention on one H100
(`roofline`'s peaks). Each input is read once and each output written
once; the weights a step reads are those of the experts its tokens hit."""
from __future__ import annotations

from roofline import PEAK_BF16_FLOPS, least_seconds


def moe_step_work(cfg: dict, tokens: int):
    """(FLOPs, bytes) of one MoE layer over `tokens` tokens in bf16: the
    router, `num_experts_per_tok` routed experts and the shared experts a
    token; the weights of min(experts, tokens * k) routed experts, the
    shared experts' and the router's, x in and y out."""
    d, f, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    k, shared = cfg["num_experts_per_tok"], cfg["n_shared_experts"] * f
    flops = 2.0 * tokens * (k * 3 * d * f + 3 * d * shared + d * e)
    weights = min(e, tokens * k) * 3 * d * f + 3 * d * shared + d * e
    return flops, 2.0 * (weights + 2 * tokens * d)


def moe_least_seconds(cfg: dict, prompt: int, new: int) -> float:
    """The MoE layers of one caption: the prefill over the prompt, then a
    token a step for the new - 1 decode steps."""
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    prefill = least_seconds(*moe_step_work(cfg, prompt), PEAK_BF16_FLOPS)
    decode = least_seconds(*moe_step_work(cfg, 1), PEAK_BF16_FLOPS)
    return layers * (prefill + (new - 1) * decode)


def mla_prefill_work(cfg: dict, prompt: int):
    """(FLOPs, bytes) of one layer's causal prefill attention: q.k at d =
    nope + rope and p.v at v's true width over the prompt(prompt + 1)/2
    live pairs a head; q and k at nope + rope, v and o at v_head_dim, once."""
    h, dv = cfg["num_attention_heads"], cfg["v_head_dim"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    pairs = prompt * (prompt + 1) / 2
    return 2.0 * h * pairs * (dqk + dv), 2.0 * h * prompt * (2 * dqk + 2 * dv)


def flash_wide_least_seconds(cfg: dict, prompt: int) -> float:
    """Every layer's prefill attention of one caption."""
    return cfg["num_hidden_layers"] * least_seconds(*mla_prefill_work(cfg, prompt),
                                                    PEAK_BF16_FLOPS)
