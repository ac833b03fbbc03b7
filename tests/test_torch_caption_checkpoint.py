"""The captioner from the reference's released files, at a small size:
`utils/convert_cli.py --llava --clip_vision` against the JAX package's
`scripts/prepare_checkpoint.py`, `CaptionAgent.from_checkpoint` (int8 and
nf4, with and without a LoRA adapter) against JAX's
`quantize_llama_params` / `merge_lora` and JAX's `CaptionAgent`, and
`cli.py caption` against the in-memory agent.

The released layout is made here: a transformers `LlamaForCausalLM`'s keys
(with the rotary tables LLaVA's 4.31-era files carry, and
`model.mm_projector.{0,2}.*`) in fp16, as two `.bin` shards and
`pytorch_model.bin.index.json`, a LLaMA-like `tokenizer.model` with its
two JSON files beside them, and a whole `CLIPModel`'s keys (text tower,
projections, `logit_scale`, position ids) in one `.bin`. Weights are
seeded numpy: N(0, 1/fan_in) matrices, norms 1 + 0.1 N(0, 1)."""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "scripts"))

from faithdiff_tpu.captioner import agent as ja  # noqa: E402
from faithdiff_tpu.captioner import clip_vision as jc  # noqa: E402
from faithdiff_tpu.captioner import llama as jl  # noqa: E402
from faithdiff_tpu.training import lora as jlora  # noqa: E402
from faithdiff_tpu_torch import cli  # noqa: E402
from faithdiff_tpu_torch.captioner import agent as ta  # noqa: E402
from faithdiff_tpu_torch.captioner import clip_vision as tc  # noqa: E402
from faithdiff_tpu_torch.captioner import llama as tl  # noqa: E402
from faithdiff_tpu_torch.captioner.llama_tokenizer import (  # noqa: E402
    LlamaTokenizer, save_sentencepiece_model)
from faithdiff_tpu_torch.training.lora import merge_lora  # noqa: E402
from faithdiff_tpu_torch.utils import convert_cli  # noqa: E402
from faithdiff_tpu_torch.utils.convert import (  # noqa: E402
    clip_vision_state_dict_from_flax, llama_state_dict_from_flax,
    projector_state_dict_from_flax)
from faithdiff_tpu_torch.utils.png import write_png  # noqa: E402
from faithdiff_tpu_torch.utils.safetensors import load_dir, save_file  # noqa: E402
from port_parity import fast_llama_tokenizer, llama_pieces  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

CORPUS = " ".join(ja.build_vicuna_prompt(ja.DEFAULT_QUESTION)) + (
    " a red house with a white door and a cat in the sun")
HIDDEN, LAYERS, CLIP_HIDDEN = 64, 2, 32
VISION = jc.tiny_vision_config()


def _vocab_size():
    return len(llama_pieces(CORPUS))


def _jax_llama_config(quant=""):
    return dataclasses.replace(jl.LlamaConfig.tiny(), vocab_size=_vocab_size(),
                               quant=quant)


def _port_llama_config():
    return tl.LlamaConfig(**dataclasses.asdict(_jax_llama_config()))


def _port_vision_config():
    return tc.CLIPVisionConfig(**dataclasses.asdict(VISION))


def _weights(shapes, seed, dtype=torch.float16):
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        x = np.asarray(rng.standard_normal(shape), np.float32)
        if key.endswith("norm.weight") or "layer_norm" in key or "layrnorm" in key:
            x = 1 + 0.1 * x
        elif key.endswith(".bias") or len(shape) == 1:
            x = 0.1 * x
        else:
            x = x / np.sqrt(np.prod(shape[1:]))
        out[key] = torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
    return out


def _llava_state_dict():
    """A released LLaVA-1.5 state dict's keys (transformers'
    `LlamaForCausalLM` names) at the tiny width, fp16."""
    cfg = _jax_llama_config()
    f, v = cfg.intermediate_size, cfg.vocab_size
    shapes = {"model.embed_tokens.weight": (v, HIDDEN), "model.norm.weight": (HIDDEN,),
              "lm_head.weight": (v, HIDDEN),
              "model.mm_projector.0.weight": (HIDDEN, CLIP_HIDDEN),
              "model.mm_projector.0.bias": (HIDDEN,),
              "model.mm_projector.2.weight": (HIDDEN, HIDDEN),
              "model.mm_projector.2.bias": (HIDDEN,)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (HIDDEN,),
                       p + "post_attention_layernorm.weight": (HIDDEN,),
                       p + "mlp.gate_proj.weight": (f, HIDDEN),
                       p + "mlp.up_proj.weight": (f, HIDDEN),
                       p + "mlp.down_proj.weight": (HIDDEN, f)})
        for n in ("q", "k", "v", "o"):
            shapes[p + f"self_attn.{n}_proj.weight"] = (HIDDEN, HIDDEN)
    sd = _weights(shapes, 0)
    head = HIDDEN // cfg.num_attention_heads
    for i in range(LAYERS):
        sd[f"model.layers.{i}.self_attn.rotary_emb.inv_freq"] = torch.from_numpy(
            1.0 / 10000 ** (np.arange(0, head, 2, dtype=np.float32) / head))
    return sd


def _clip_tower_shapes(prefix, d, f, layers, embeddings):
    shapes = dict(embeddings)
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            shapes[p + f"self_attn.{n}_proj.weight"] = (d, d)
            shapes[p + f"self_attn.{n}_proj.bias"] = (d,)
        for n in ("layer_norm1", "layer_norm2"):
            shapes[p + n + ".weight"] = shapes[p + n + ".bias"] = (d,)
        shapes.update({p + "mlp.fc1.weight": (f, d), p + "mlp.fc1.bias": (f,),
                       p + "mlp.fc2.weight": (d, f), p + "mlp.fc2.bias": (d,)})
    return shapes


def _clip_state_dict():
    """openai/clip-vit-large-patch14-336's layout (a whole CLIPModel, in
    transformers' names) at the tiny vision width, fp16."""
    d, n_pos = VISION.hidden_size, (VISION.image_size // VISION.patch_size) ** 2 + 1
    shapes = _clip_tower_shapes("vision_model", d, VISION.intermediate_size,
                                VISION.num_hidden_layers, {
        "vision_model.embeddings.class_embedding": (d,),
        "vision_model.embeddings.patch_embedding.weight":
            (d, 3, VISION.patch_size, VISION.patch_size),
        "vision_model.embeddings.position_embedding.weight": (n_pos, d),
        "vision_model.pre_layrnorm.weight": (d,), "vision_model.pre_layrnorm.bias": (d,),
        "vision_model.post_layernorm.weight": (d,),
        "vision_model.post_layernorm.bias": (d,)})
    shapes.update(_clip_tower_shapes("text_model", 16, 32, 1, {
        "text_model.embeddings.token_embedding.weight": (99, 16),
        "text_model.embeddings.position_embedding.weight": (16, 16),
        "text_model.final_layer_norm.weight": (16,),
        "text_model.final_layer_norm.bias": (16,)}))
    shapes.update({"visual_projection.weight": (8, d), "text_projection.weight": (8, 16)})
    sd = _weights(shapes, 1)
    sd["vision_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    sd["logit_scale"] = torch.tensor(2.6592)
    return sd


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The released files, and the converted directory of convert_cli."""
    root = tmp_path_factory.mktemp("llava")
    llava = root / "llava-v1.5-13b"
    llava.mkdir()
    sd = _llava_state_dict()
    keys = sorted(sd)
    shards = {"pytorch_model-00001-of-00002.bin": keys[:len(keys) // 2],
              "pytorch_model-00002-of-00002.bin": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        torch.save({k: sd[k] for k in ks}, llava / name)
    (llava / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    save_sentencepiece_model(str(llava / "tokenizer.model"), llama_pieces(CORPUS))
    (llava / "tokenizer_config.json").write_text(json.dumps(
        {"add_bos_token": True, "add_eos_token": False, "legacy": False}))
    (llava / "special_tokens_map.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
         "pad_token": "<unk>"}))
    clip = root / "clip" / "pytorch_model.bin"
    clip.parent.mkdir()
    clip_sd = _clip_state_dict()
    torch.save(clip_sd, clip)
    out = root / "converted"
    assert convert_cli.main(["--llava", str(llava), "--clip_vision", str(clip),
                             "--out_dir", str(out)]) == 0
    return dict(llava=sd, clip=clip_sd, dir=llava, cap=str(out / "captioner"),
                root=root)


@pytest.fixture(scope="module")
def jax_trees(released, tmp_path_factory):
    """JAX's `prepare_checkpoint.prepare` of the same state dicts, read back.
    JAX's `convert_llama` raises on the rotary tables and its
    `convert_clip_vision` keeps a CLIPModel's other keys in its tree, so
    JAX gets the LM keys without `rotary_emb.inv_freq` and the CLIP file's
    `vision_model.*` keys (a CLIPVisionModel's file)."""
    from prepare_checkpoint import prepare

    from faithdiff_tpu.training.checkpoint import load_params

    out = tmp_path_factory.mktemp("jax_ckpt")
    llava = {k: v for k, v in released["llava"].items() if "rotary_emb" not in k}
    vision = {k: v for k, v in released["clip"].items() if k.startswith("vision_model.")}
    written = prepare(out=str(out), state_dicts={"llava": llava,
                                                 "clip_vision": vision})
    assert set(written) == {"captioner/llama", "captioner/projector", "captioner/vision"}
    return {name: load_params(str(out / "captioner" / name))
            for name in ("llama", "projector", "vision")}


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_reader_equals_prepare_checkpoint(released, jax_trees):
    """convert_cli's captioner dir equals JAX's trees carried into the
    port's names, bit for bit (the fp16 files, widened to fp32 as JAX
    widens them); the tokenizer files are copied."""
    cap = released["cap"]
    carries = {"llama": llama_state_dict_from_flax,
               "projector": projector_state_dict_from_flax,
               "vision": clip_vision_state_dict_from_flax}
    for name, carry in carries.items():
        got = load_dir(os.path.join(cap, name))
        assert all(v.dtype == torch.float16 for v in got.values()), name
        _assert_equal({k: v.float() for k, v in got.items()},
                      carry({"params": jax_trees[name]}))
    assert len(os.listdir(os.path.join(cap, "llama"))) == 2       # a file a shard
    assert sorted(os.listdir(os.path.join(cap, "tokenizer"))) == [
        "special_tokens_map.json", "tokenizer.model", "tokenizer_config.json"]


def test_reader_takes_a_file_an_index_and_checks_the_index(released, tmp_path):
    d = released["dir"]
    shards, keys = convert_cli.llava_shards(str(d / "pytorch_model.bin.index.json"))
    assert [os.path.basename(s) for s in shards] == [
        "pytorch_model-00001-of-00002.bin", "pytorch_model-00002-of-00002.bin"]
    assert keys == sorted(released["llava"])
    assert convert_cli.llava_shards(str(d / "missing.bin"))[0] == shards
    one = tmp_path / "one.bin"
    torch.save(released["llava"], one)
    convert_cli.main(["--llava", str(one), "--out_dir", str(tmp_path / "o")])
    _assert_equal(load_dir(str(tmp_path / "o" / "captioner" / "llama")),
                  load_dir(os.path.join(released["cap"], "llama")))
    index = json.loads((d / "pytorch_model.bin.index.json").read_text())
    index["weight_map"]["model.layers.9.mlp.up_proj.weight"] = \
        "pytorch_model-00002-of-00002.bin"
    bad = tmp_path / "bad.index.json"
    bad.write_text(json.dumps(index))
    for shard in shards:
        os.symlink(shard, tmp_path / os.path.basename(shard))
    with pytest.raises(KeyError, match="absent from the shards"):
        convert_cli.main(["--llava", str(bad), "--out_dir", str(tmp_path / "b")])


def test_reconverting_into_the_same_dir_leaves_no_stale_file(released, tmp_path):
    """A two-shard release, then a one-file release with other weights and
    no tokenizer files, into one --out_dir: the second conversion's files
    alone remain (the first's model-00002-of-00002 would sort after the
    second's model-00001-of-00001 and override it)."""
    clip = released["root"] / "clip" / "pytorch_model.bin"
    out = tmp_path / "o"
    convert_cli.main(["--llava", str(released["dir"]), "--clip_vision", str(clip),
                      "--out_dir", str(out)])
    cap = out / "captioner"
    (cap / "vision" / "zz-stale.safetensors").write_bytes(
        (cap / "vision" / "model.safetensors").read_bytes())
    one = tmp_path / "one.bin"
    torch.save({k: -v if v.is_floating_point() else v
                for k, v in released["llava"].items()}, one)
    vision_sd = {k: -v if v.is_floating_point() else v
                 for k, v in released["clip"].items()}
    torch.save(vision_sd, tmp_path / "clip.bin")
    convert_cli.main(["--llava", str(one), "--clip_vision", str(tmp_path / "clip.bin"),
                      "--out_dir", str(out)])
    assert os.listdir(cap / "llama") == ["model-00001-of-00001.safetensors"]
    assert os.listdir(cap / "vision") == ["model.safetensors"]
    assert not os.path.exists(cap / "tokenizer")
    first = load_dir(os.path.join(released["cap"], "llama"))
    _assert_equal(load_dir(str(cap / "llama")), {k: -v for k, v in first.items()})
    first = load_dir(os.path.join(released["cap"], "vision"))
    _assert_equal(load_dir(str(cap / "vision")), {k: -v for k, v in first.items()})


def _port_agent(cap, **kw):
    return ta.CaptionAgent.from_checkpoint(
        cap, dtype=torch.float32, device="cpu", llama_config=_port_llama_config(),
        vision_config=_port_vision_config(), **kw)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_from_checkpoint_buffers_equal_jax_quantisation(released, jax_trees, mode):
    agent = _port_agent(released["cap"], load_4bit=mode == "nf4")
    want = llama_state_dict_from_flax(
        {"params": jl.quantize_llama_params(jax_trees["llama"], mode)})
    _assert_equal(agent.llama.state_dict(), want)
    kinds = {type(m).__name__ for m in agent.llama.modules()}
    assert ("NF4Dense" if mode == "nf4" else "Int8Dense") in kinds
    _assert_equal(agent.projector.state_dict(),
                  projector_state_dict_from_flax({"params": jax_trees["projector"]}))


def test_from_checkpoint_infers_mpt_and_leaves_it_unquantised(released, tmp_path):
    """A directory named for MPT loads `MPTForCausalLM` with no
    quantisation, at load_8bit and at load_4bit, as JAX's from_checkpoint
    picks the model and the mode."""
    from faithdiff_tpu_torch.captioner import mpt as tm

    shapes = {k: tuple(v.shape) for k, v in
              tm.MPTForCausalLM(tm.MPTConfig.tiny()).state_dict().items()}
    sd = _weights(shapes, 7, torch.float32)
    cap = tmp_path / "llava-mpt-captioner"
    (cap / "llama").mkdir(parents=True)
    save_file(sd, str(cap / "llama" / "model.safetensors"))
    for name in ("projector", "vision", "tokenizer"):
        os.symlink(os.path.join(released["cap"], name), cap / name)
    for load_4bit in (False, True):
        agent = ta.CaptionAgent.from_checkpoint(
            str(cap), dtype=torch.float32, device="cpu", load_4bit=load_4bit,
            llama_config=tm.MPTConfig.tiny(), vision_config=_port_vision_config())
        assert isinstance(agent.llama, tm.MPTForCausalLM)
        _assert_equal(agent.llama.state_dict(), sd)


def test_from_checkpoint_refuses_a_missing_card(released):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.CaptionAgent.from_checkpoint(released["cap"])


def test_captions_equal_jax_agent(released, jax_trees):
    """Greedy captions of the loaded int8 agent (the CLI's default) equal
    JAX's `CaptionAgent` on the same trees, JAX with the fast tokenizer of
    the same file, the port with its own."""
    kw = dict(temperature=0.0, max_new_tokens=10)
    cfg = _jax_llama_config("int8")
    jax_agent = ja.CaptionAgent(
        llama=jl.LlamaForCausalLM(cfg),
        llama_params={"params": jl.quantize_llama_params(jax_trees["llama"], "int8")},
        vision=jc.CLIPVisionTower(VISION),
        vision_params={"params": jax_trees["vision"]},
        projector=jc.VisionProjector(HIDDEN),
        projector_params={"params": jax_trees["projector"]},
        tokenizer=fast_llama_tokenizer(str(released["dir"] / "tokenizer.model"),
                                       legacy=False), **kw)
    ours = _port_agent(released["cap"])
    ours.temperature, ours.max_new_tokens = kw["temperature"], kw["max_new_tokens"]
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (40 + 16 * i, 56, 3), dtype=np.uint8) for i in range(2)]
    want = [jax_agent.caption(im) for im in images]
    assert [ours.caption(im) for im in images] == want
    assert any(want)


def _lora(seed=5, rank=3):
    """A PEFT-style adapter in the port's names on q_proj and down_proj,
    with `_alpha`, and the same adapter as JAX's LoRA tree."""
    rng = np.random.default_rng(seed)
    ours = {"_alpha": torch.tensor(6.0)}
    tree = {"_alpha": jnp.asarray(6.0, jnp.float32), "model": {}}
    cfg = _jax_llama_config()
    for i in range(LAYERS):
        for group, name, (out_f, in_f) in (
                ("self_attn", "q_proj", (HIDDEN, HIDDEN)),
                ("mlp", "down_proj", (HIDDEN, cfg.intermediate_size))):
            a = rng.standard_normal((rank, in_f)).astype(np.float32)
            b = rng.standard_normal((out_f, rank)).astype(np.float32) * 0.1
            key = f"model.layers.{i}.{group}.{name}"
            ours[key + ".lora_A.weight"] = torch.from_numpy(a)
            ours[key + ".lora_B.weight"] = torch.from_numpy(b)
            node = tree["model"].setdefault(f"layers_{i}", {})
            if group == "self_attn":
                node = node.setdefault("self_attn", {})
            node[name] = {"lora_A": a.T, "lora_B": b.T}
    return ours, tree


def test_lora_merge_equals_jax(released, jax_trees, tmp_path):
    """`merge_lora` within 1e-6 of JAX's on the fp32 weights, and a
    checkpoint's `lora/` merged before the int8 quantisation as JAX's
    from_checkpoint merges it."""
    ours, tree = _lora()
    merged = llama_state_dict_from_flax(
        {"params": jlora.merge_lora(jax_trees["llama"], tree)})
    base = llama_state_dict_from_flax({"params": jax_trees["llama"]})
    got = merge_lora(base, ours)
    assert sorted(got) == sorted(merged)
    changed = 0
    for k in merged:
        np.testing.assert_allclose(got[k].numpy(), merged[k].numpy(), rtol=0, atol=1e-6)
        changed += not torch.equal(got[k], base[k])
    assert changed == 2 * LAYERS

    cap = tmp_path / "captioner"
    (cap / "lora").mkdir(parents=True)
    for name in ("projector", "vision", "tokenizer", "llama"):
        os.symlink(os.path.join(released["cap"], name), cap / name)
    save_file(ours, str(cap / "lora" / "adapter.safetensors"))
    agent = _port_agent(str(cap))
    want = jl.quantize_llama_params(jlora.merge_lora(jax_trees["llama"], tree), "int8")
    _assert_equal(agent.llama.state_dict(), llama_state_dict_from_flax({"params": want}))


def test_cli_caption_equals_in_memory_agent(released, monkeypatch, tmp_path, capsys):
    """`cli.main(["caption", ...])` on the CPU at the tiny configs: its JSON
    equal to the in-memory agent's caption of each image (one image a
    call, seed 0, the agent's defaults); a second run skips both;
    `--use_bsrnet` gives the same JSON; a JPEG is captioned as Pillow
    decodes it, and a truncated one raises before the captioner loads."""
    load = ta.CaptionAgent.from_checkpoint

    def tiny(ckpt_dir, **kw):
        return load(ckpt_dir, llama_config=_port_llama_config(),
                    vision_config=_port_vision_config(), **kw)

    monkeypatch.setattr(ta.CaptionAgent, "from_checkpoint", staticmethod(tiny))
    img_dir = tmp_path / "in"
    img_dir.mkdir()
    rng = np.random.default_rng(4)
    images = {"b_photo": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
              "a_photo": rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)}
    for name, im in images.items():
        write_png(str(img_dir / f"{name}.png"), im)
    argv = ["caption", "--img_dir", str(img_dir), "--captioner_dir", released["cap"],
            "--device", "cpu"]
    assert cli.main(argv + ["--save_dir", str(tmp_path / "caps")]) == 0
    agent = tiny(released["cap"], device="cpu")
    assert isinstance(agent.tokenizer, LlamaTokenizer)
    for name, im in images.items():
        got = json.loads((tmp_path / "caps" / f"{name}.json").read_text())
        assert got == {"caption": agent.caption(im, seed=0)}
    first = {p: p.read_text() for p in (tmp_path / "caps").iterdir()}
    capsys.readouterr()
    assert cli.main(argv + ["--save_dir", str(tmp_path / "caps")]) == 0
    assert capsys.readouterr().out.count("skip ") == 2
    assert {p: p.read_text() for p in (tmp_path / "caps").iterdir()} == first
    assert cli.main(argv + ["--save_dir", str(tmp_path / "bsr"), "--use_bsrnet"]) == 0
    assert "--use_bsrnet is not applied" in capsys.readouterr().out
    assert {p.name: p.read_text() for p in (tmp_path / "bsr").iterdir()} == \
        {p.name: t for p, t in first.items()}
    from PIL import Image

    Image.fromarray(images["a_photo"]).save(img_dir / "c_photo.jpg", quality=90)
    assert cli.main(argv + ["--save_dir", str(tmp_path / "jpg")]) == 0
    decoded = np.asarray(Image.open(img_dir / "c_photo.jpg").convert("RGB"))
    assert json.loads((tmp_path / "jpg" / "c_photo.json").read_text()) == {
        "caption": agent.caption(decoded, seed=0)}
    (img_dir / "d_photo.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match=r"d_photo\.jpg: truncated JPEG"):
        cli.main(argv + ["--save_dir", str(tmp_path / "jpg2")])
    assert not (tmp_path / "jpg2").exists()


def test_cli_caption_needs_a_card_unless_told(released, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    img_dir = tmp_path / "in"
    img_dir.mkdir()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["caption", "--img_dir", str(img_dir), "--save_dir",
                  str(tmp_path / "o"), "--captioner_dir", released["cap"]])
