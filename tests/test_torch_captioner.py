"""The port's LLaMA and MPT decoders and `greedy_generate`
(`faithdiff_tpu_torch/captioner/llama.py`, `mpt.py`) against the JAX
package at tiny configs, fp32. Flax params are made with numpy and carried
into the port by its own `llama_state_dict_from_flax` /
`mpt_state_dict_from_flax`; quantised trees come from the JAX package's
`quantize_llama_params`, so the port reads the JAX bytes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.captioner import llama as jl
from faithdiff_tpu.captioner import mpt as jm
from faithdiff_tpu_torch.captioner import llama as tl
from faithdiff_tpu_torch.captioner import mpt as tm
from faithdiff_tpu_torch.utils.convert import (llama_state_dict_from_flax,
                                               mpt_state_dict_from_flax)
from port_parity import random_params

CONFIGS = {"fp": jl.LlamaConfig.tiny(),
           "int8": dataclasses.replace(jl.LlamaConfig.tiny(), quant="int8"),
           "nf4": dataclasses.replace(jl.LlamaConfig.tiny(), quant="nf4"),
           "mistral": jl.LlamaConfig.tiny_mistral()}


def _pair(name, seed=0):
    """(flax model, flax params, port model) with the same weights."""
    cfg = CONFIGS[name]
    fp_cfg = dataclasses.replace(cfg, quant="")
    ids = jnp.zeros((1, 4), jnp.int32)
    params = random_params(jl.LlamaForCausalLM(fp_cfg), seed, ids, ids,
                           method=jl.LlamaForCausalLM.init_forward,
                           norm_leaves=("weight",))
    if cfg.quant:
        params = {"params": jl.quantize_llama_params(params["params"], cfg.quant)}
    ours = tl.LlamaForCausalLM(tl.LlamaConfig(**dataclasses.asdict(cfg)))
    ours.load_state_dict(llama_state_dict_from_flax(params), strict=True)
    return jl.LlamaForCausalLM(cfg), params, ours.eval()


def _prompt(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_logits_match_jax(name):
    fmod, params, ours = _pair(name)
    emb = _prompt(2, 12, 64, 1)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    want, _ = fmod.apply(params, jnp.asarray(emb), jnp.asarray(pos))
    with torch.no_grad():
        got, _ = ours(torch.from_numpy(emb), torch.from_numpy(pos.copy()))
    # fp32 on both sides; sums, rsqrt and sin/cos round in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["fp", "nf4", "mistral"])
def test_kv_cache_decode_matches_full_forward(name):
    """Greedy decode over the cache equals the argmax of full forwards."""
    _, _, ours = _pair(name, seed=3)
    emb = torch.from_numpy(_prompt(1, 5, 64, 2))
    got = tl.greedy_generate(ours, emb, max_new_tokens=6, eos_token_id=-1).tokens[0]
    ref = []
    with torch.no_grad():
        for _ in range(6):
            s = emb.shape[1]
            logits, _ = ours(emb, torch.arange(s)[None])
            ref.append(int(logits[0, -1].argmax()))
            emb = torch.cat([emb, ours.embed(torch.tensor([[ref[-1]]]))], dim=1)
    assert got.tolist() == ref


def _generate_both(fmod, params, ours, emb, **kw):
    want = jl.greedy_generate(fmod, params, jnp.asarray(emb), **kw)
    got = tl.greedy_generate(ours, torch.from_numpy(emb), **kw)
    return (np.asarray(want.tokens), np.asarray(want.lengths),
            got.tokens.numpy(), got.lengths.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_generate_equals_jax(name):
    """Identical tokens and lengths at temperature 0, then again with an
    eos id and a two-token stop sequence taken from JAX's first run, so
    both stop rules fire."""
    fmod, params, ours = _pair(name, seed=4)
    emb = _prompt(3, 7, 64, 5) * 0.5
    wt, wl, gt, gl = _generate_both(fmod, params, ours, emb, max_new_tokens=8,
                                    eos_token_id=-1)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gl, wl)
    eos, stop = int(wt[0, 4]), (int(wt[1, 2]), int(wt[1, 3]))
    wt, wl, gt, gl = _generate_both(fmod, params, ours, emb, max_new_tokens=8,
                                    eos_token_id=eos, stop_sequences=(stop,))
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gl, wl)
    assert wl[0] <= 4 and wl[1] <= 2        # eos and keyword stops fired


def test_greedy_generate_pad_len_equals_jax():
    """Left-padded batch (batched anyres): masked prefill and decode."""
    fmod, params, ours = _pair("fp", seed=6)
    emb = _prompt(2, 9, 64, 7)
    emb[1, :3] = 0.0
    pad = np.asarray([0, 3], np.int32)
    want = jl.greedy_generate(fmod, params, jnp.asarray(emb), max_new_tokens=5,
                              eos_token_id=-1, pad_len=jnp.asarray(pad))
    got = tl.greedy_generate(ours, torch.from_numpy(emb), max_new_tokens=5,
                             eos_token_id=-1, pad_len=torch.from_numpy(pad))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def _top_p_rule(logits, top_p):
    """`_sample_tokens`'s filter (`llama.py:352-358`) in numpy, fp64."""
    srt = np.sort(logits, axis=-1)[:, ::-1]
    e = np.exp(srt - srt[:, :1])
    cum = np.cumsum(e / e.sum(-1, keepdims=True), axis=-1)
    cut = np.take_along_axis(srt, (cum < top_p).sum(-1, keepdims=True), axis=-1)
    return logits >= cut


def test_top_p_filter_follows_sample_tokens_rule():
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((4, 50)) * 3).astype(np.float32)
    kept = tl.top_p_filter(torch.from_numpy(logits), 0.7).numpy() > -1e29
    np.testing.assert_array_equal(kept, _top_p_rule(logits.astype(np.float64), 0.7))
    # every token JAX's sampler draws lies in the kept set
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    draws = jax.vmap(lambda k: jl._sample_tokens(jnp.asarray(logits), k, 1.0, 0.7))(keys)
    rows = np.broadcast_to(np.arange(4), draws.shape)
    assert kept[rows, np.asarray(draws)].all()
    # sampling in the port stays in the kept set too
    g = torch.Generator().manual_seed(0)
    for _ in range(16):
        tok = tl._sample_tokens(torch.from_numpy(logits), g, 1.0, 0.7).numpy()
        assert kept[np.arange(4), tok].all()


def test_mpt_logits_and_generate_match_jax():
    cfg = jm.MPTConfig.tiny()
    ids = jnp.zeros((1, 4), jnp.int32)
    fmod = jm.MPTForCausalLM(cfg)
    params = random_params(fmod, 9, ids, ids, method=jm.MPTForCausalLM.init_forward,
                           norm_leaves=("weight",))
    ours = tm.MPTForCausalLM(tm.MPTConfig(**dataclasses.asdict(cfg))).eval()
    ours.load_state_dict(mpt_state_dict_from_flax(params), strict=True)
    emb = _prompt(2, 10, 64, 10)
    want, _ = fmod.apply(params, jnp.asarray(emb))
    with torch.no_grad():
        got, _ = ours(torch.from_numpy(emb))
    # fp32 on both sides, rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    wt, wl, gt, gl = _generate_both(fmod, params, ours, emb, max_new_tokens=6,
                                    eos_token_id=-1)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gl, wl)


def test_quantize_llama_params_equals_jax():
    """The port's quantize_llama_params on carried fp weights gives the
    state dict carried from JAX's quantised tree, byte for byte."""
    fp_cfg = jl.LlamaConfig.tiny()
    ids = jnp.zeros((1, 4), jnp.int32)
    params = random_params(jl.LlamaForCausalLM(fp_cfg), 11, ids, ids,
                           method=jl.LlamaForCausalLM.init_forward,
                           norm_leaves=("weight",))
    fp_sd = llama_state_dict_from_flax(params)
    for mode in ("int8", "nf4"):
        ours = tl.quantize_llama_params(fp_sd, mode)
        want = llama_state_dict_from_flax(jl.quantize_llama_params(params["params"], mode))
        assert set(ours) == set(want), mode
        for k in want:
            assert ours[k].dtype == want[k].dtype, k
            assert torch.equal(ours[k], want[k]), k
