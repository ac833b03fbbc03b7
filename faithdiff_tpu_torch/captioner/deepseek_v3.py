"""DeepSeek-V3 decoder as the captioner's language model: Kimi-VL-A3B's
LM (https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct, config.json),
multi-head latent attention (MLA) over a latent KV cache and sigmoid-routed
mixture-of-experts layers with shared experts.

The equations, per layer (`h` the residual stream):

- block: `h = x + MLA(RMSNorm(x))`, `y = h + FFN(RMSNorm(h))`; after the
  last layer `RMSNorm` and an untied `lm_head`;
- MLA: `q = W_q x` split per head into `q_nope` (qk_nope_head_dim) and
  `q_pe` (qk_rope_head_dim); `[c_kv | k_pe] = W_kv_a x`, `c_kv =
  RMSNorm(c_kv)` (kv_lora_rank values); `[k_nope | v] = W_kv_b c_kv` per
  head; RoPE (theta = rope_theta) on `q_pe` and on `k_pe`, which is one per
  token, shared by every head, in DeepSeek-V3's pairwise layout (the pair
  (x[2i], x[2i+1]) turns by position * theta^(-2i/d)); `k = [k_nope | k_pe]`,
  `q = [q_nope | q_pe]`, a causal softmax at scale 1/sqrt(nope + rope),
  then `W_o` over the heads' `v_head_dim` outputs;
- FFN: layers below `first_k_dense_replace` a SwiGLU MLP at
  `intermediate_size`; the rest a MoE layer: `s = sigmoid(W_r x)` in fp32,
  the chosen experts the top `num_experts_per_tok` of `s +
  e_score_correction_bias` (the bias picks, it never weights), weights
  `s[chosen] / sum(s[chosen]) * routed_scaling_factor`, `y = sum_i w_i
  E_i(x) + S(x)` with `E(x) = W_down(silu(W_gate x) * W_up x)` at
  `moe_intermediate_size` and the shared `S` the same at
  `n_shared_experts * moe_intermediate_size`.

The cache of a layer is one tensor [B, max_len, kv_lora_rank +
qk_rope_head_dim]: the normed `c_kv` and the roped `k_pe` of each token
(576 values at Kimi-VL-A3B's widths, against 2 * heads * d for LLaMA). The
prefill expands `k_nope` and `v` from `c_kv` and runs the causal attention
through `ops.attention.flash_attention` at d = nope + rope (v padded with
zeros to that width: the wide bf16 kernel on a card takes one d); a decode
step attends over the latent cache with `W_kv_b` absorbed into the query
and the output (MQA over [c_kv | k_pe]), which reads 576 values a cached
token instead of expanding 2 * heads * 128. On a card `greedy_generate`
replays a decode step captured as a CUDA graph (`DecodeGraph`).

The MoE layer routes on the device with no host synchronisation and a
fixed number of launches whatever the routing: the token-expert pairs are
sorted by expert (`argsort`), the per-expert counts made by a
`scatter_add_` and a `cumsum`, and the sorted rows go through two grouped
products (`torch._grouped_mm`: gate and up fused, then down), are put back
in pair order and summed with their weights. Counters, while the program's
recorder is on: `moe.assignments` (token-expert pairs) and, where a
profiler runs too, `moe.max_expert_load` (the most pairs one expert got in
a call, summed over the calls); leaf ranges `moe` and `mla` around each
call under a profiler, outside graph captures (a replay's kernels run in
no range).

Departures and limits: on a card the routed experts run in bf16 (the
dtype `torch._grouped_mm` takes there); `q_lora_rank` null only
(Kimi-VL-A3B's), one expert group (`n_group` = `topk_group` = 1, so `noaux_tc` is the plain top-k of
the biased scores), no `rope_scaling`, no attention bias, untied head,
no quantised storage. Parameter names follow transformers' DeepseekV3
modules (`model.layers.{i}.self_attn.kv_a_proj_with_mqa`, `.mlp.gate`,
`.mlp.shared_experts.gate_proj`), except the routed experts, held stacked
as `mlp.experts.gate_up_proj` [E, 2F, D] (gate rows first) and
`mlp.experts.down_proj` [E, D, F]; reading a released checkpoint (its key
map) waits until its files are in the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..utils import profiling
from .llama import RMSNorm, _inv_freq


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    """transformers' DeepseekV3 `config.json` keys (Kimi-VL-A3B's
    `text_config`); the defaults are Kimi-VL-A3B's."""
    vocab_size: int = 163840
    max_position_embeddings: int = 131072
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    ep_size: int = 1
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    seq_aux: bool = True
    num_key_value_heads: int = 16
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False

    @staticmethod
    def kimi_vl_a3b() -> "DeepseekV3Config":
        return DeepseekV3Config()

    @staticmethod
    def tiny() -> "DeepseekV3Config":
        return DeepseekV3Config(
            vocab_size=256, max_position_embeddings=256, hidden_size=64,
            intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
            n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
            qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16,
            rope_theta=10000.0)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token holds in a layer's cache: [c_kv | k_pe]."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def _check_supported(cfg: DeepseekV3Config) -> None:
    unsupported = dict(q_lora_rank=cfg.q_lora_rank is not None,
                       n_group=cfg.n_group != 1 or cfg.topk_group != 1,
                       scoring_func=cfg.scoring_func != "sigmoid",
                       rope_scaling=cfg.rope_scaling is not None,
                       attention_bias=cfg.attention_bias,
                       tie_word_embeddings=cfg.tie_word_embeddings,
                       moe_layer_freq=cfg.moe_layer_freq != 1,
                       hidden_act=cfg.hidden_act != "silu")
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"DeepseekV3 settings the port does not run: {bad}")


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _leaf(name: str):
    """`profiling.leaf`, but not while a graph is captured: a range around
    a capture would hold none of the kernels its replays run."""
    return contextlib.nullcontext() if _capturing() else profiling.leaf(name)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """(cos, sin) [B, S, dim/2] fp32 of the positions [B, S], made once a
    forward and shared by every layer."""
    freqs = positions.float()[..., None] * _inv_freq(dim, theta, positions.device)
    return torch.cos(freqs), torch.sin(freqs)


def rope_pairwise(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding: the pair (x[2i], x[2i+1]) of the last
    axis turned by the angle whose (cos, sin) are broadcast against x's
    leading axes. Computed in fp32, returned in x's dtype, pairs kept in
    place."""
    xf = x.float().unflatten(-1, (-1, 2))
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return out.flatten(-2).to(x.dtype)


class MLP(nn.Module):
    """SwiGLU MLP: the dense layers' FFN and the shared experts."""

    def __init__(self, hidden: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(hidden, width, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(width, hidden, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLAttention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(d, h * cfg.qk_head_dim, bias=False, dtype=dtype)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.latent_dim, bias=False, dtype=dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank,
                                   h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                   bias=False, dtype=dtype)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, bias=False, dtype=dtype)
        self.scale = 1.0 / math.sqrt(cfg.qk_head_dim)

    def forward(self, x, rope, cache=None, cache_index=0, attn_len=None):
        """x [B, S, D]; rope: (cos, sin) [B, S, rope/2]. `cache` [B, MAX,
        latent] is written in place at `cache_index` (an int, or for a
        captured decode step a device scalar). S > 1 is the causal prefill
        from position 0; S == 1 a decode step over the cache's rows up to
        `attn_len`."""
        with _leaf("mla"):
            return self._forward(x, rope, cache, cache_index, attn_len)

    def _forward(self, x, rope, cache, cache_index, attn_len):
        cfg = self.cfg
        b, s, _ = x.shape
        h, nope, rdim = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        cos, sin = rope
        q = self.q_proj(x).view(b, s, h, cfg.qk_head_dim)
        q_nope, q_pe = q.split((nope, rdim), dim=-1)
        q_pe = rope_pairwise(q_pe, cos[:, :, None], sin[:, :, None])
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split((cfg.kv_lora_rank, rdim), dim=-1)
        latent = torch.cat((self.kv_a_layernorm(c_kv), rope_pairwise(k_pe, cos, sin)), dim=-1)
        if cache is not None:
            if torch.is_tensor(cache_index):
                cache.index_copy_(1, cache_index.reshape(1), latent)
            else:
                cache[:, cache_index:cache_index + s] = latent
        if s > 1:
            out = self._prefill(q_nope, q_pe, latent)
        else:
            out = self._decode(q_nope, q_pe, cache, attn_len)
        return self.o_proj(out.reshape(b, s, h * cfg.v_head_dim))

    def _prefill(self, q_nope, q_pe, latent):
        """Causal attention over the prompt, k_nope and v expanded from c_kv:
        [B, S, H, v_head_dim]."""
        cfg = self.cfg
        b, s, h, nope = q_nope.shape
        c_kv, k_pe = latent.split((cfg.kv_lora_rank, cfg.qk_rope_head_dim), dim=-1)
        k_nope, v = self.kv_b_proj(c_kv).view(b, s, h, nope + cfg.v_head_dim).split(
            (nope, cfg.v_head_dim), dim=-1)
        q = torch.cat((q_nope, q_pe), dim=-1).transpose(1, 2).contiguous()
        k = torch.cat((k_nope, k_pe[:, :, None].expand(b, s, h, -1)),
                      dim=-1).transpose(1, 2).contiguous()
        v = F.pad(v, (0, cfg.qk_head_dim - cfg.v_head_dim)).transpose(1, 2).contiguous()
        out = flash_attention(q, k, v, self.scale, causal=True)
        return out[..., :cfg.v_head_dim].transpose(1, 2)

    def _decode(self, q_nope, q_pe, latent, attn_len):
        """One query a sample over the latent cache [B, L, latent], W_kv_b
        absorbed: q_nope goes through W_uk into the latent space, the scores
        are [q_lat | q_pe] . [c_kv | k_pe] in fp32 over every row, those past
        `attn_len` masked (so a step's shapes are the same at every
        position), and the latent output goes through W_uv.
        [B, 1, H, v_head_dim]."""
        cfg = self.cfg
        b, _, h, nope = q_nope.shape
        r = cfg.kv_lora_rank
        w = self.kv_b_proj.weight.view(h, nope + cfg.v_head_dim, r)
        w_uk, w_uv = w[:, :nope], w[:, nope:]
        q_lat = torch.matmul(q_nope[:, 0].transpose(0, 1), w_uk)          # [H, B, r]
        q_cat = torch.cat((q_lat.transpose(0, 1), q_pe[:, 0]), dim=-1)   # [B, H, r + rope]
        lat = latent.float()
        scores = torch.matmul(q_cat.float(), lat.transpose(1, 2)) * self.scale  # [B, H, L]
        live = torch.arange(lat.shape[1], device=lat.device) <= attn_len
        p = torch.softmax(scores.masked_fill(~live, float("-inf")), dim=-1)
        o_lat = torch.matmul(p.to(latent.dtype).float(), lat[..., :r]).to(latent.dtype)
        out = torch.matmul(o_lat.transpose(0, 1), w_uv.transpose(1, 2))   # [H, B, v]
        return out.transpose(0, 1)[:, None]


def grouped_linear(x: torch.Tensor, weight: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of x sorted by group, row block g (ending at offs[g]) times
    weight[g]^T: x [N, in], weight [G, out, in] -> [N, out]."""
    return torch._grouped_mm(x, weight.transpose(-2, -1), offs=offs)


class Experts(nn.Module):
    """The routed experts, stacked: gate and up in one [E, 2F, D] tensor."""

    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        e, d, f = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty((e, 2 * f, d), dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty((e, d, f), dtype=dtype))

    def forward(self, x_sorted: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        gate, up = grouped_linear(x_sorted, self.gate_up_proj, offs).chunk(2, dim=-1)
        return grouped_linear(F.silu(gate) * up, self.down_proj, offs)


class Router(nn.Module):
    """`mlp.gate`: sigmoid scores in fp32, top-k of the bias-corrected
    scores, normalised weights of the uncorrected ones."""

    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty((cfg.n_routed_experts, cfg.hidden_size),
                                               dtype=dtype))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts, dtype=torch.float32))

    def forward(self, x: torch.Tensor):
        """x [T, D] -> (experts [T, k] int64, weights [T, k] fp32)."""
        cfg = self.cfg
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        chosen = torch.topk(scores + self.e_score_correction_bias, cfg.num_experts_per_tok,
                            dim=-1, sorted=False).indices
        w = scores.gather(-1, chosen)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return chosen, w * cfg.routed_scaling_factor


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg, dtype)
        self.experts = Experts(cfg, dtype)
        self.shared_experts = MLP(cfg.hidden_size,
                                  cfg.n_shared_experts * cfg.moe_intermediate_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _leaf("moe"):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        t, k = x.shape[0], cfg.num_experts_per_tok
        chosen, weights = self.gate(x)
        flat = chosen.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(cfg.n_routed_experts, dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        y_sorted = self.experts(x[order // k], offs)
        y = torch.empty_like(y_sorted)
        y[order] = y_sorted                     # back in (token, slot) order
        routed = (y.view(t, k, -1).float() * weights[..., None]).sum(dim=1)
        if profiling.recording_on() and not _capturing():
            profiling.count("moe.assignments", t * k)
            if torch.autograd._profiler_enabled():
                # a host read of the counts: only where a profiler runs too,
                # so that the recorder's own timings are not synchronised
                profiling.count("moe.max_expert_load", int(counts.max()))
        return (routed + self.shared_experts(x).float()).to(x.dtype).view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, index: int, dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = (MLP(cfg.hidden_size, cfg.intermediate_size, dtype)
                    if index < cfg.first_k_dense_replace else MoE(cfg, dtype))

    def forward(self, x, rope, cache=None, cache_index=0, attn_len=None):
        x = x + self.self_attn(self.input_layernorm(x), rope, cache, cache_index, attn_len)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV3Model(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class DeepseekV3ForCausalLM(nn.Module):
    """The LM with `greedy_generate`'s interface: `embed(ids)`,
    `init_caches(...)` and `forward(inputs_embeds, positions, caches,
    cache_index, attn_len) -> (logits, caches)`."""

    def __init__(self, config: DeepseekV3Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.model = DeepseekV3Model(config, dtype)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False,
                                 dtype=dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(input_ids)

    def decode_graph(self, caches: List[torch.Tensor]) -> Optional["DecodeGraph"]:
        """A decode step over `caches` captured as one CUDA graph
        (`greedy_generate` replays it a token), or None off a card."""
        return DecodeGraph(self, caches) if caches[0].is_cuda else None

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None) -> List[torch.Tensor]:
        """One latent cache a layer: [batch, max_len, kv_lora_rank +
        qk_rope_head_dim], zeros."""
        cfg = self.config
        return [torch.zeros((batch, max_len, cfg.latent_dim), dtype=dtype, device=device)
                for _ in range(cfg.num_hidden_layers)]

    def forward(self, inputs_embeds, positions, kv_caches=None, cache_index=0,
                attn_len=None):
        cfg = self.config
        rope = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
        x = inputs_embeds
        for i, layer in enumerate(self.model.layers):
            x = layer(x, rope, kv_caches[i] if kv_caches is not None else None,
                      cache_index, attn_len)
        return self.lm_head(self.model.norm(x)), kv_caches

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> None:
        """Seeded weights in place: each matrix N(0, 1/in) over its last
        axis (the stacked experts' too), norm scales 1, correction bias
        N(0, 0.05^2)."""
        for name, p in self.named_parameters():
            if name.endswith("e_score_correction_bias"):
                p.normal_(0.0, 0.05, generator=generator)
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)


class DecodeGraph:
    """One decode step of `model` over `caches` captured as a CUDA graph: a
    step's ~2,900 kernel launches become one replay, so the step is paced by
    the card rather than by the host. The MoE layers route on the card with
    fixed launches and the attention masks the cache past the step's row,
    so one capture serves every position. Static inputs: the fed-back token
    ids and their positions [B, 1] and the cache row the step writes; static
    outputs, overwritten by each replay: the step's logits [B, vocab]
    (`logits`) and each MoE layer's chosen experts [B, k] (`routes`, by
    layer index). The counter `moe.assignments` is kept a replay."""

    def __init__(self, model: DeepseekV3ForCausalLM, caches: List[torch.Tensor]):
        cfg, dev = model.config, caches[0].device
        batch, rows = caches[0].shape[:2]
        self.model, self.caches = model, caches
        self.tokens = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.positions = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        # the warm-up writes the cache's last row, which no step attends to
        self.row = torch.full((), rows - 1, dtype=torch.long, device=dev)
        self.pairs = batch * cfg.num_experts_per_tok * (cfg.num_hidden_layers
                                                        - cfg.first_k_dense_replace)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.routes = {}
        hooks = [layer.mlp.gate.register_forward_hook(self._keep_route(i))
                 for i, layer in enumerate(model.model.layers) if isinstance(layer.mlp, MoE)]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.logits = self._step()
        finally:
            for h in hooks:
                h.remove()

    def _keep_route(self, i: int):
        """A hook that keeps the router's output tensor of the capture: a
        replay writes it in place."""
        def keep(module, args, out):
            self.routes[i] = out[0]
        return keep

    def _step(self) -> torch.Tensor:
        logits, _ = self.model(self.model.embed(self.tokens), self.positions, self.caches,
                               self.row, self.row)
        return logits[:, -1]

    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor, row: int) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.row.fill_(row)
        self.graph.replay()
        profiling.count("moe.assignments", self.pairs)
        return self.logits
