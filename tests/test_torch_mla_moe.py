"""The DeepSeek-V3 language model of the captioner (Kimi-VL-A3B's LM:
`faithdiff_tpu_torch/captioner/deepseek_v3.py`) against its plain fp32
reference (`captioner/deepseek_v3_reference.py`), on the CPU at a tiny
size: the full forward, prefill then decode through the latent cache, the
router, the MoE layer's fixed op sequence, the caption agent's path, the
LLaMA and MPT caches behind `init_caches`, and Kimi-VL-A3B's published
widths."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from faithdiff_tpu_torch.captioner import agent as ta
from faithdiff_tpu_torch.captioner import deepseek_v3 as dv3
from faithdiff_tpu_torch.captioner import deepseek_v3_reference as ref
from faithdiff_tpu_torch.captioner.clip_vision import tiny_vision_config
from faithdiff_tpu_torch.captioner.llama import (LlamaConfig, LlamaForCausalLM,
                                                 greedy_generate, init_kv_caches)
from faithdiff_tpu_torch.captioner.mpt import MPTConfig, MPTForCausalLM, init_mpt_kv_caches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "faithdiff-sdxl-kimivl-a3b-bf16.json")

# Kimi-VL-A3B-Instruct's text_config, as its config.json gives it
# (https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct/blob/main/config.json)
KIMI_VL_A3B = {
    "vocab_size": 163840, "max_position_embeddings": 131072, "hidden_size": 2048,
    "intermediate_size": 11264, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64, "ep_size": 1,
    "routed_scaling_factor": 2.446, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
    "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "seq_aux": True, "num_key_value_heads": 16,
    "hidden_act": "silu", "rms_norm_eps": 1e-05, "rope_theta": 800000,
    "rope_scaling": None, "attention_bias": False, "tie_word_embeddings": False}


def _model(seed=0, **changes):
    cfg = dataclasses.replace(dv3.DeepseekV3Config.tiny(), **changes)
    model = dv3.DeepseekV3ForCausalLM(cfg).eval().requires_grad_(False)
    model.random_init_(torch.Generator().manual_seed(seed))
    return model


def _reference(model, embeds, rows=None):
    sd = model.state_dict()
    return ref.forward(dataclasses.asdict(model.config), embeds, lambda n: sd[n].float(), rows)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("seed", [0, 1])
def test_full_forward_matches_the_reference(seed):
    model = _model(seed)
    x = torch.randn(1, 24, model.config.hidden_size, generator=torch.Generator().manual_seed(seed))
    logits, _ = model(x, torch.arange(24)[None])
    assert _rel(logits[0], _reference(model, x[0])) < 1e-5


def test_prefill_then_decode_through_the_latent_cache_matches_the_full_forward():
    model = _model(3)
    cfg = model.config
    s, new = 10, 6
    x = torch.randn(1, s + new, cfg.hidden_size, generator=torch.Generator().manual_seed(3))
    want = _reference(model, x[0])
    caches = model.init_caches(1, s + new, torch.float32)
    assert [tuple(c.shape) for c in caches] == [(1, s + new, cfg.latent_dim)] * 3
    logits, _ = model(x[:, :s], torch.arange(s)[None], caches, 0, s - 1)
    rows = [logits[0, -1]]
    for i in range(s, s + new):
        logits, _ = model(x[:, i:i + 1], torch.tensor([[i]]), caches, i, i)
        rows.append(logits[0, -1])
    for j, row in enumerate(rows):
        assert _rel(row, want[s - 1 + j]) < 1e-5, j
    # the cache holds the normed c_kv and the roped k_pe of every token
    assert caches[0][:, s + new - 1].abs().sum() > 0


def test_absorbed_decode_equals_expanded_attention():
    """W_kv_b absorbed into q and the output reads the same attention as
    k_nope and v expanded from the cache."""
    model = _model(4)
    attn, cfg = model.model.layers[0].self_attn, model.config
    g = torch.Generator().manual_seed(4)
    latent = torch.randn(2, 9, cfg.latent_dim, generator=g)
    q_nope = torch.randn(2, 1, cfg.num_attention_heads, cfg.qk_nope_head_dim, generator=g)
    q_pe = torch.randn(2, 1, cfg.num_attention_heads, cfg.qk_rope_head_dim, generator=g)
    got = attn._decode(q_nope, q_pe, latent, 8)
    c_kv, k_pe = latent.split((cfg.kv_lora_rank, cfg.qk_rope_head_dim), -1)
    kvb = attn.kv_b_proj(c_kv).view(2, 9, cfg.num_attention_heads, -1)
    k = torch.cat((kvb[..., :cfg.qk_nope_head_dim],
                   k_pe[:, :, None].expand(-1, -1, cfg.num_attention_heads, -1)), -1)
    v = kvb[..., cfg.qk_nope_head_dim:]
    q = torch.cat((q_nope, q_pe), -1)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * attn.scale, -1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v)
    assert _rel(got, want) < 1e-5


def test_rope_turns_adjacent_pairs():
    x = torch.randn(3, 5, 8)
    pos = torch.arange(3)[None]
    cos, sin = dv3.rope_tables(pos, 8, 10000.0)
    got = dv3.rope_pairwise(x[None], cos[:, :, None], sin[:, :, None])[0]
    inv = 1.0 / 10000.0 ** (torch.arange(0, 8, 2).float() / 8)
    z = torch.view_as_complex(x.reshape(3, 5, 4, 2).contiguous())
    turn = torch.polar(torch.ones(3, 4), pos[0, :, None].float() * inv)[:, None]
    want = torch.view_as_real(z * turn).reshape(3, 5, 8)
    assert torch.allclose(got, want, atol=1e-6)
    assert torch.allclose(ref.rope(x, pos[0], 10000.0), want, atol=1e-6)


def test_correction_bias_picks_experts_but_never_weights_them():
    moe = _model(5).model.layers[1].mlp
    cfg = moe.cfg
    x = torch.randn(32, cfg.hidden_size, generator=torch.Generator().manual_seed(5))
    scores = torch.sigmoid(F.linear(x, moe.gate.weight))
    moe.gate.e_score_correction_bias.zero_()
    chosen0, w0 = moe.gate(x)
    bias = torch.zeros(cfg.n_routed_experts)
    bias[3] = 10.0                              # expert 3 is chosen for every token
    moe.gate.e_score_correction_bias.copy_(bias)
    chosen1, w1 = moe.gate(x)
    assert (chosen1 == 3).any(dim=-1).all() and not (chosen0 == 3).any(dim=-1).all()
    for chosen, w in ((chosen0, w0), (chosen1, w1)):
        s = scores.gather(-1, chosen)
        assert torch.allclose(w, s / s.sum(-1, keepdim=True) * cfg.routed_scaling_factor,
                              rtol=1e-6)
        assert torch.allclose(w.sum(-1), torch.full((32,), cfg.routed_scaling_factor))


def test_moe_layer_matches_a_loop_over_experts():
    moe = _model(6).model.layers[2].mlp
    x = torch.randn(2, 7, moe.cfg.hidden_size, generator=torch.Generator().manual_seed(6))
    got = moe(x)
    sd = {k: v.float() for k, v in moe.state_dict().items()}
    want, own = ref.moe(dataclasses.asdict(moe.cfg), x.reshape(14, -1), lambda n: sd[n], "")
    assert _rel(got.reshape(14, -1), want) < 1e-5
    chosen, _ = moe.gate(x.reshape(14, -1))
    assert torch.equal(chosen.sort(-1).values, own.sort(-1).values)


def test_reference_takes_the_programs_routes():
    """Forced routes equal to the reference's own give the same logits;
    other routes change them; `seen` holds the reference's own top-k."""
    model = _model(10)
    x = torch.randn(1, 12, model.config.hidden_size, generator=torch.Generator().manual_seed(10))
    seen, again = {}, {}
    want = _reference(model, x[0])
    sd = model.state_dict()
    cfg = dataclasses.asdict(model.config)
    got = ref.forward(cfg, x[0], lambda n: sd[n].float(), routes=None, seen=seen)
    assert sorted(seen) == [1, 2] and seen[1].shape == (12, model.config.num_experts_per_tok)
    forced = ref.forward(cfg, x[0], lambda n: sd[n].float(), routes=seen, seen=again)
    assert torch.equal(got, want) and torch.allclose(forced, want, rtol=1e-6, atol=1e-6)
    other = {i: (r + 1) % model.config.n_routed_experts for i, r in seen.items()}
    assert _rel(ref.forward(cfg, x[0], lambda n: sd[n].float(), routes=other), want) > 1e-2


def _ops(fn):
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return seen


@pytest.mark.parametrize("tokens", [1, 9])
def test_moe_runs_the_same_ops_whatever_the_routing(tokens):
    """A fixed op sequence (so a fixed launch count) for any routing, and no
    host read of a device value inside the layer."""
    moe = _model(7).model.layers[1].mlp
    g = torch.Generator().manual_seed(7)
    x = torch.randn(1, tokens, moe.cfg.hidden_size, generator=g)
    bias = torch.zeros(moe.cfg.n_routed_experts)
    bias[:moe.cfg.num_experts_per_tok] = 10.0       # every token to the same experts
    x3 = x * 3
    seqs = [_ops(lambda: moe(x))]
    moe.gate.e_score_correction_bias.copy_(bias)
    seqs.append(_ops(lambda: moe(x3)))
    assert seqs[0] == seqs[1]
    assert not {"aten._local_scalar_dense", "aten.nonzero", "aten.item"} & set(seqs[0])


def test_grouped_linear_is_a_product_a_group():
    g = torch.Generator().manual_seed(8)
    x, w = torch.randn(10, 16, generator=g), torch.randn(4, 24, 16, generator=g)
    offs = torch.tensor([3, 3, 7, 10], dtype=torch.int32)
    want = torch.cat([x[0:3] @ w[0].T, x[3:7] @ w[2].T, x[7:10] @ w[3].T])
    assert torch.allclose(dv3.grouped_linear(x, w, offs), want, atol=1e-5)


class _Tok:
    eos_token_id = 10 ** 6                     # never sampled: every caption runs to the cap

    def __call__(self, text, add_special_tokens=True, return_tensors="np"):
        ids = [(ord(c) % 200) + 10 for c in text[:12]]
        ids = np.asarray([[1] + ids if add_special_tokens else ids], np.int64)
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def test_caption_agent_runs_the_lm_to_max_new_tokens():
    agent = ta.build_caption_agent(_Tok(), dv3.DeepseekV3Config.tiny(), tiny_vision_config(),
                                   dtype=torch.float32, device="cpu", seed=3)
    assert isinstance(agent.llama, dv3.DeepseekV3ForCausalLM)
    agent.max_new_tokens = 7
    image = np.random.default_rng(0).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    captions = agent.caption_batch([image, image[::-1]], seed=5)
    assert [len(c.split()) for c in captions] == [7, 7]
    assert captions == agent.caption_batch([image, image[::-1]], seed=5)


def test_caption_agent_built_without_weights_takes_the_callers():
    """`init=False` leaves the weights to the caller: every tensor on the
    device, none on meta, and once loaded the agent captions as the agent
    it was loaded from."""
    args = (_Tok(), dv3.DeepseekV3Config.tiny(), tiny_vision_config())
    src = ta.build_caption_agent(*args, dtype=torch.float32, device="cpu", seed=3)
    dst = ta.build_caption_agent(*args, dtype=torch.float32, device="cpu", init=False)
    for part in ("llama", "vision", "projector"):
        tensors = list(getattr(dst, part).state_dict().values())
        assert tensors and all(t.device.type == "cpu" for t in tensors)
        getattr(dst, part).load_state_dict(getattr(src, part).state_dict())
    src.max_new_tokens = dst.max_new_tokens = 5
    image = np.random.default_rng(1).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    assert dst.caption(image, seed=2) == src.caption(image, seed=2)


def test_random_init_scales_the_stacked_experts_by_their_input_width():
    model = _model(11, n_routed_experts=64, moe_intermediate_size=256)
    experts = model.model.layers[1].mlp.experts
    for w, fan_in in ((experts.gate_up_proj, 64), (experts.down_proj, 256)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.02
    bias = model.model.layers[1].mlp.gate.e_score_correction_bias
    assert bias.dtype == torch.float32 and 0.02 < float(bias.std()) < 0.1
    assert all(bool((p == 1).all()) for n, p in model.named_parameters() if n.endswith("norm.weight"))


def test_greedy_generate_refuses_pad_len_for_the_latent_cache():
    model = _model(9)
    with pytest.raises(ValueError, match="LLaMA-family"):
        greedy_generate(model, torch.zeros(2, 4, model.config.hidden_size), 2,
                        pad_len=torch.tensor([0, 1]))


@pytest.mark.parametrize("family", ["llama", "mistral", "mpt"])
def test_llama_and_mpt_caches_are_unchanged_by_init_caches(family):
    if family == "mpt":
        cfg = MPTConfig.tiny()
        model, want = MPTForCausalLM(cfg), init_mpt_kv_caches(cfg, 2, 11, torch.bfloat16)
    else:
        cfg = LlamaConfig.tiny() if family == "llama" else LlamaConfig.tiny_mistral()
        model, want = LlamaForCausalLM(cfg), init_kv_caches(cfg, 2, 11, torch.bfloat16)
    got = model.init_caches(2, 11, torch.bfloat16)
    assert len(got) == len(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        for g, w in ((gk, wk), (gv, wv)):
            assert g.shape == w.shape and g.dtype == w.dtype and not g.any()


def test_kimi_vl_a3b_is_the_published_config_and_the_benchmarks():
    cfg = dv3.DeepseekV3Config.kimi_vl_a3b()
    assert dataclasses.asdict(cfg) == KIMI_VL_A3B
    with open(CONFIG) as f:
        bench = json.load(f)
    assert {k: bench[k] for k in KIMI_VL_A3B} == KIMI_VL_A3B
    assert bench["reduced"] == [] and bench["use_fp8"] is False
    assert bench["captioner"]["max_new_tokens"] == 512


def test_kimi_vl_a3b_counts_15_96_billion_parameters():
    cfg = dv3.DeepseekV3Config.kimi_vl_a3b()
    with torch.device("meta"):
        model = dv3.DeepseekV3ForCausalLM(cfg, dtype=torch.bfloat16)
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e9, 2) == 15.96
    layer = sum(p.numel() for p in model.model.layers[1].parameters())
    assert round(layer / 1e6, 1) == 584.8
    shapes = ref.parameter_shapes(dataclasses.asdict(cfg))
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == shapes


def test_benchmark_keeps_a_copy_of_the_reference():
    with open(ref.__file__) as a, open(os.path.join(ROOT, "benchmark", "reference",
                                                    "deepseek_v3.py")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("field,value", [("q_lora_rank", 1536), ("n_group", 8),
                                         ("scoring_func", "softmax"),
                                         ("tie_word_embeddings", True)])
def test_settings_outside_the_port_are_refused(field, value):
    with pytest.raises(NotImplementedError, match=field):
        dv3.DeepseekV3ForCausalLM(dataclasses.replace(dv3.DeepseekV3Config.tiny(),
                                                      **{field: value}))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_decode_step_replays_the_eager_step(card):
    """`DecodeGraph` on the card: each replay gives the eager step's logits,
    its MoE layers' expert choices (the graph's static `routes`) and writes
    the same cache rows. In bf16, as on the card the grouped products take
    it, at head dims the flash kernels take (nope + rope = 64)."""
    model = _model(12, qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32)
    model = model.to(card, torch.bfloat16)
    cfg, s, new = model.config, 6, 5
    x = torch.randn(1, s, cfg.hidden_size, device=card, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (new,), device=card)
    moe = [i for i, layer in enumerate(model.model.layers) if isinstance(layer.mlp, dv3.MoE)]
    runs = []
    for graphed in (False, True):
        caches = model.init_caches(1, s + new + 1, torch.bfloat16, card)
        model(x, torch.arange(s, device=card)[None], caches, 0, s - 1)
        graph = dv3.DecodeGraph(model, caches) if graphed else None
        rows, routes = [], []
        for i in range(new):
            pos = torch.full((1, 1), s + i, device=card)
            if graph is None:
                seen = {}
                hooks = [model.model.layers[j].mlp.gate.register_forward_hook(
                    lambda m, a, out, j=j: seen.__setitem__(j, out[0].clone())) for j in moe]
                rows.append(model(model.embed(toks[i].view(1, 1)), pos, caches, s + i,
                                  s + i)[0][:, -1].clone())
                for h in hooks:
                    h.remove()
            else:
                rows.append(graph(toks[i].view(1, 1), pos, s + i).clone())
                seen = {j: graph.routes[j].clone() for j in moe}
            routes.append(torch.stack([seen[j] for j in moe]))
        runs.append((torch.cat(rows), torch.stack(routes),
                     [c[:, :s + new].clone() for c in caches]))
    (eager, r_eager, c_eager), (graphed, r_graphed, c_graphed) = runs
    assert torch.equal(graphed, eager)
    assert torch.equal(r_graphed, r_eager)
    assert all(torch.equal(a, b) for a, b in zip(c_graphed, c_eager))
