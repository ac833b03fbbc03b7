"""The port's CLIP text towers (`faithdiff_tpu_torch.models.clip_text`)
against the JAX package's, with the same weights carried by
`utils.convert.clip_text_state_dict_from_flax`, and against transformers'
`CLIPTextModel` / `CLIPTextModelWithProjection`, whose state dicts load
strictly into the port's towers. fp32 on the CPU, tolerance 1e-5.

The JAX CLI's tiny towers have vocab 128, so the hash tokenizer's EOS is
127 and no 49407 is found: both packages pool at position 0 (`argmax` of
an all-false match). The transformers cases use a vocab of 49408, where
BOS / EOS are 49406 / 49407 as in SDXL's files."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from faithdiff_tpu.config import CLIPTextConfig as JaxCLIPTextConfig
from faithdiff_tpu.models.clip_text import CLIPTextTower as JaxTower
from faithdiff_tpu.models.clip_text import SDXLTextEncoder as JaxEncoder
from faithdiff_tpu.models.tokenizer import HashTokenizer
from faithdiff_tpu_torch.config import CLIPTextConfig, tiny_text_encoder_configs
from faithdiff_tpu_torch.models.clip_text import CLIPTextTower, SDXLTextEncoder
from faithdiff_tpu_torch.utils.convert import (
    clip_text_state_dict_from_flax, clip_text_state_dict_from_reference)
from port_parity import random_params

TOL = 1e-5
MANIFESTS = os.path.join(os.path.dirname(__file__), "manifests")
PROMPTS = ["a photo of a red house", "", "the cat sits on the rug " * 20]


def _jax_config(cfg: CLIPTextConfig) -> JaxCLIPTextConfig:
    return JaxCLIPTextConfig(**dataclasses.asdict(cfg))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tower", [0, 1], ids=["vit_l", "bigg"])
def test_tower_matches_jax(tower):
    """Penultimate, final and pooled outputs of one tiny tower (ViT-L's
    quick_gelu; bigG's exact-erf gelu and text projection)."""
    cfg = tiny_text_encoder_configs()[tower]
    ids, _ = HashTokenizer(cfg.vocab_size)(PROMPTS)
    jmod = JaxTower(config=_jax_config(cfg))
    params = random_params(jmod, 10 + tower, jnp.asarray(ids))
    want = jmod.apply(params, jnp.asarray(ids))
    port = CLIPTextTower(cfg)
    port.load_state_dict(clip_text_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    for g, w in zip(got, want):
        _close(g, w)


def test_sdxl_text_encoder_matches_jax():
    """Both tiny towers: [B, 77, 64] prompt embeds (32 + 32 wide) and the
    second tower's projected pooled output."""
    c1, c2 = tiny_text_encoder_configs()
    ids, _ = HashTokenizer(128)(PROMPTS)
    jmod = JaxEncoder(config_1=_jax_config(c1), config_2=_jax_config(c2))
    params = random_params(jmod, 12, jnp.asarray(ids), jnp.asarray(ids))
    want = jmod.apply(params, jnp.asarray(ids), jnp.asarray(ids))
    port = SDXLTextEncoder(c1, c2)
    port.load_state_dict(clip_text_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(ids))
    assert got[0].shape == (3, 77, 64) and got[1].shape == (3, 64)
    for g, w in zip(got, want):
        _close(g, w)


def _ids_49408(seed, pad):
    """[3, 77] ids as the CLIP tokenizer gives them: BOS, words, EOS, then
    `pad` (EOS for tower 1, `!` = 0 for tower 2); the last row is full."""
    rng = np.random.default_rng(seed)
    ids = np.full((3, 77), pad, np.int64)
    for row, n in enumerate((5, 0, 75)):
        ids[row, 0] = 49406
        ids[row, 1:1 + n] = rng.integers(1, 49406, n)
        ids[row, 1 + n] = 49407
    return ids


@pytest.mark.parametrize("with_projection", [False, True],
                         ids=["CLIPTextModel", "CLIPTextModelWithProjection"])
def test_transformers_state_dict_loads_strictly(with_projection):
    """A seeded tiny transformers tower: its state dict (without the
    `position_ids` buffer) loads strictly; the penultimate hidden states,
    the final-LN states and the pooled output / `text_embeds` agree."""
    torch.manual_seed(4 + with_projection)
    kw = dict(vocab_size=49408, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=77, bos_token_id=49406,
              eos_token_id=49407, pad_token_id=49407,
              hidden_act="gelu" if with_projection else "quick_gelu",
              attn_implementation="eager")
    if with_projection:
        ref = transformers.CLIPTextModelWithProjection(
            transformers.CLIPTextConfig(projection_dim=48, **kw))
    else:
        ref = transformers.CLIPTextModel(transformers.CLIPTextConfig(**kw))
    ref.eval()
    cfg = CLIPTextConfig(vocab_size=49408, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         hidden_act=kw["hidden_act"],
                         projection_dim=48 if with_projection else None)
    port = CLIPTextTower(cfg)
    sd = dict(ref.state_dict(), **{"text_model.embeddings.position_ids":
                                   torch.arange(77)[None]})
    port.load_state_dict(clip_text_state_dict_from_reference(sd), strict=True)
    ids = torch.from_numpy(_ids_49408(6, pad=0 if with_projection else 49407))
    with torch.no_grad():
        out = ref(input_ids=ids, output_hidden_states=True)
        pen, final, pooled = port(ids)
    torch.testing.assert_close(pen, out.hidden_states[-2], rtol=TOL, atol=TOL)
    torch.testing.assert_close(final, out.last_hidden_state, rtol=TOL, atol=TOL)
    want = out.text_embeds if with_projection else out.pooler_output
    torch.testing.assert_close(pooled, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tower,manifest", [
    ("text_encoder", "clip_text_l.json"), ("text_encoder_2", "clip_text_bigg.json")])
def test_full_width_keys_match_manifest(tower, manifest):
    """The full-width towers' state-dict keys and shapes are those of
    SDXL's `text_encoder/` (ViT-L/14) and `text_encoder_2/` (bigG) files."""
    with open(os.path.join(MANIFESTS, manifest)) as f:
        want = {k: tuple(v) for k, v in json.load(f).items()
                if k != "text_model.embeddings.position_ids"}
    with torch.device("meta"):
        enc = SDXLTextEncoder()
    got = {k: tuple(v.shape)
           for k, v in getattr(enc, tower).state_dict().items()}
    assert got == want
    assert getattr(enc, tower).config.hidden_act == (
        "quick_gelu" if tower == "text_encoder" else "gelu")
