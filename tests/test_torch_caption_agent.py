"""The port's vision tower, projector, image preprocessing, caption agent
and captioner weight carry against the JAX package (tiny configs, fp32):
`faithdiff_tpu_torch/captioner/clip_vision.py`, `agent.py` and the
captioner half of `utils/convert.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.captioner import agent as ja
from faithdiff_tpu.captioner import clip_vision as jc
from faithdiff_tpu.captioner import llama as jl
from faithdiff_tpu.utils import convert as jconv
from faithdiff_tpu_torch.captioner import agent as ta
from faithdiff_tpu_torch.captioner import clip_vision as tc
from faithdiff_tpu_torch.captioner import llama as tl
from faithdiff_tpu_torch.utils.convert import (clip_vision_state_dict_from_flax,
                                               llama_state_dict_from_flax,
                                               mpt_state_dict_from_flax,
                                               projector_state_dict_from_flax)
from port_parity import random_params
from test_caption_agent import StubTokenizer


def _vision_pair(seed=0):
    cfg = jc.tiny_vision_config()
    fmod = jc.CLIPVisionTower(cfg)
    pix = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    params = random_params(fmod, seed, pix)
    ours = tc.CLIPVisionTower(tc.CLIPVisionConfig(**dataclasses.asdict(cfg)))
    ours.load_state_dict(clip_vision_state_dict_from_flax(params), strict=True)
    return fmod, params, ours.eval()


def _projector_pair(in_dim, out_dim, seed=1):
    fmod = jc.VisionProjector(out_dim)
    params = random_params(fmod, seed, jnp.zeros((1, 3, in_dim)))
    ours = tc.VisionProjector(out_dim, in_dim)
    ours.load_state_dict(projector_state_dict_from_flax(params), strict=True)
    return fmod, params, ours.eval()


def test_vision_tower_and_projector_match_flax():
    fmod, params, ours = _vision_pair()
    pix = np.random.default_rng(0).standard_normal((2, 56, 56, 3)).astype(np.float32)
    want = fmod.apply(params, jnp.asarray(pix))
    pfmod, pparams, pours = _projector_pair(32, 64)
    with torch.no_grad():
        got = ours(torch.from_numpy(pix))
        proj = pours(got)
    assert got.shape == (2, 16, 32)
    # fp32 on both sides; sums and the conv in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(proj.numpy(),
                               np.asarray(pfmod.apply(pparams, want)),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("hw,size,pad", [
    ((40, 64), 56, True), ((1024, 768), 336, True), ((50, 50), 56, True),
    ((17, 90), 112, True), ((300, 200), 56, False), ((20, 31), 56, False)])
def test_preprocess_clip_image_is_bit_exact_to_pil(hw, size, pad):
    """The numpy bicubic resize against the JAX preprocessing, which uses
    PIL: down- and upscaling, square and not, padded and not."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    ours = tc.preprocess_clip_image(img, size, pad_square=pad)
    want = jc.preprocess_clip_image(img, size, pad_square=pad)
    np.testing.assert_array_equal(ours, want)


def test_process_anyres_image_matches_jax():
    img = np.random.default_rng(3).integers(0, 256, (40, 90, 3), dtype=np.uint8)
    grids = [(56, 56), (112, 56), (56, 112)]
    assert tc.select_best_resolution((90, 40), grids) == \
        jc.select_best_resolution((90, 40), grids)
    np.testing.assert_array_equal(tc.process_anyres_image(img, 56, str(grids)),
                                  jc.process_anyres_image(img, 56, str(grids)))


def _agents(**kw):
    """A JAX and a port CaptionAgent with the same tiny weights."""
    vf, vp, vt = _vision_pair(2)
    lcfg = jl.LlamaConfig.tiny()
    pf, pp, pt = _projector_pair(32, lcfg.hidden_size, 3)
    ids = jnp.zeros((1, 4), jnp.int32)
    lf = jl.LlamaForCausalLM(lcfg)
    lp = random_params(lf, 4, ids, ids, method=jl.LlamaForCausalLM.init_forward,
                       norm_leaves=("weight",))
    lt = tl.LlamaForCausalLM(tl.LlamaConfig(**dataclasses.asdict(lcfg)))
    lt.load_state_dict(llama_state_dict_from_flax(lp), strict=True)
    jax_agent = ja.CaptionAgent(llama=lf, llama_params=lp, vision=vf, vision_params=vp,
                                projector=pf, projector_params=pp,
                                tokenizer=StubTokenizer(), **kw)
    ours = ta.CaptionAgent(llama=lt.eval(), vision=vt, projector=pt,
                           tokenizer=StubTokenizer(), **kw)
    return jax_agent, ours


def test_caption_agent_strings_equal_jax():
    jax_agent, ours = _agents(max_new_tokens=6, temperature=0.0)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (32 + 8 * i, 48, 3), np.uint8) for i in range(3)]
    want = jax_agent.caption_batch(images)
    assert ours.caption_batch(images) == want
    assert ours.caption(images[0]) == jax_agent.caption(images[0])
    emb, pad = ours.build_multimodal_embeds(images[:1], "q?", image_aspect_ratio="square")
    jemb, jpad = jax_agent.build_multimodal_embeds(images[:1], "q?",
                                                   image_aspect_ratio="square")
    assert pad is None and jpad is None
    # fp32; the vision tower and projector round in another order
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-5, atol=2e-5)


def test_caption_agent_batched_anyres_pad_len_equals_jax():
    """Batched anyres with different patch counts: a left-padded batch with
    pad_len masking (`tests/test_caption_agent.py:132-177`)."""
    jax_agent, ours = _agents(max_new_tokens=5, temperature=0.0)
    grids = [(56, 56), (112, 56)]
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (50, 50, 3)).astype(np.uint8),
              rng.integers(0, 255, (40, 90, 3)).astype(np.uint8)]
    _, pad_len = ours.build_multimodal_embeds(images, "q?", image_aspect_ratio="anyres",
                                              anyres_grid_pinpoints=grids)
    assert pad_len.tolist() == [16, 0]
    kw = dict(image_aspect_ratio="anyres", anyres_grid_pinpoints=grids)
    assert ours.caption_batch(images, "q?", **kw) == \
        jax_agent.caption_batch(images, "q?", **kw)


# ---------------------------------------------------------------------------
# weight carry, cross-checked against faithdiff_tpu/utils/convert.py
# ---------------------------------------------------------------------------

def _random_sd(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


def _assert_same(ours, want):
    assert set(ours) == set(want)
    for k in want:
        assert torch.equal(ours[k], want[k]), k


def test_llama_carry_inverts_convert_llama():
    d, f, v = 16, 24, 40
    shapes = {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,),
              "lm_head.weight": (v, d)}
    for i in range(2):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (d,),
                       p + "post_attention_layernorm.weight": (d,),
                       p + "mlp.gate_proj.weight": (f, d), p + "mlp.up_proj.weight": (f, d),
                       p + "mlp.down_proj.weight": (d, f)})
        for n in ("q", "k", "v", "o"):
            shapes[p + f"self_attn.{n}_proj.weight"] = (d, d)
    sd = _random_sd(shapes, 0)
    _assert_same(llama_state_dict_from_flax({"params": jconv.convert_llama(sd)}), sd)


def test_clip_and_projector_carry_invert_convert():
    d, f = 8, 16
    shapes = {"vision_model.embeddings.class_embedding": (d,),
              "vision_model.embeddings.patch_embedding.weight": (d, 3, 14, 14),
              "vision_model.embeddings.position_embedding.weight": (17, d),
              "vision_model.pre_layrnorm.weight": (d,),
              "vision_model.pre_layrnorm.bias": (d,)}
    p = "vision_model.encoder.layers.0."
    for n in ("q", "k", "v", "out"):
        shapes[p + f"self_attn.{n}_proj.weight"] = (d, d)
        shapes[p + f"self_attn.{n}_proj.bias"] = (d,)
    for n, s in (("layer_norm1", d), ("layer_norm2", d)):
        shapes[p + n + ".weight"], shapes[p + n + ".bias"] = (s,), (s,)
    shapes.update({p + "mlp.fc1.weight": (f, d), p + "mlp.fc1.bias": (f,),
                   p + "mlp.fc2.weight": (d, f), p + "mlp.fc2.bias": (d,)})
    sd = _random_sd(shapes, 1)
    # transformers' extras that LLaVA does not use
    extra = {"vision_model.post_layernorm.weight": torch.ones(d),
             "vision_model.embeddings.position_ids": torch.arange(17)[None]}
    tree = jconv.convert_clip_vision({**sd, **extra})
    _assert_same(clip_vision_state_dict_from_flax(tree), sd)

    psd = _random_sd({"0.weight": (12, d), "0.bias": (12,), "2.weight": (12, 12),
                      "2.bias": (12,)}, 2)
    tree = jconv.convert_vision_projector({f"mm_projector.{k}": v for k, v in psd.items()})
    _assert_same(projector_state_dict_from_flax({"params": tree}), psd)


def test_mpt_carry_inverts_convert_mpt():
    d = 8
    shapes = {"transformer.wte.weight": (30, d), "transformer.norm_f.weight": (d,)}
    p = "transformer.blocks.0."
    shapes.update({p + "norm_1.weight": (d,), p + "norm_2.weight": (d,),
                   p + "attn.Wqkv.weight": (3 * d, d), p + "attn.out_proj.weight": (d, d),
                   p + "ffn.up_proj.weight": (4 * d, d),
                   p + "ffn.down_proj.weight": (d, 4 * d)})
    sd = _random_sd(shapes, 3)
    _assert_same(mpt_state_dict_from_flax(jconv.convert_mpt(sd)), sd)


def _abstract_keys(carry, fmod, *args, **kwargs):
    """Keys the carry gives for `fmod`'s full-size flax tree, from
    zero-size stand-ins of its leaves (eval_shape: nothing is allocated)."""
    shapes = jax.eval_shape(lambda: fmod.init(jax.random.PRNGKey(0), *args, **kwargs))
    tree = jax.tree_util.tree_map(lambda s: np.zeros((0,) * s.ndim, s.dtype), shapes)
    return set(carry(tree))


def test_full_width_key_sets_match():
    """LLaVA-1.5-13B (nf4) and ViT-L/14-336: the carried keys are the
    full-width port modules' keys (the port built on the meta device)."""
    cfg = jl.LlamaConfig.llava_13b()
    ids = jnp.zeros((1, 4), jnp.int32)
    with torch.device("meta"):
        llama = tl.LlamaForCausalLM(tl.LlamaConfig(quant="nf4"), dtype=torch.bfloat16)
        vision = tc.CLIPVisionTower(tc.CLIPVisionConfig())
    want = _abstract_keys(llama_state_dict_from_flax,
                          jl.LlamaForCausalLM(dataclasses.replace(cfg, quant="nf4")),
                          ids, ids, method=jl.LlamaForCausalLM.init_forward)
    assert set(llama.state_dict()) == want
    assert len(want) == 40 * (7 * 2 + 2) + 3   # packed+absmax, norms; embed, norm, head
    pix = jnp.zeros((1, 336, 336, 3))
    assert set(vision.state_dict()) == _abstract_keys(
        clip_vision_state_dict_from_flax, jc.CLIPVisionTower(jc.CLIPVisionConfig()), pix)
