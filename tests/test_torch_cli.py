"""The port's restore and embed CLI end to end at the tiny configs, on the
CPU.

Checkpoints in the reference's layout are made from JAX-package params
(`export_to_torch_state_dict`, split as FaithDiff.bin is) and numpy-made
text towers in transformers' layout: an SDXL dir with `unet/` and the two
text towers, FaithDiff.bin and a VAE dir. The port's `convert_cli` turns
them into its checkpoint dir, and `cli.main(["restore", "--tiny", ...])`
restores a PNG from it, within 1 uint8 level of the JAX package's pipeline
with the same params on PIL's LANCZOS upscale of the same input: with zero
embeds, and with a caption and a negative prompt through the tokenizer
(transformers' `CLIPTokenizer` on the JAX side) and the tiny text towers
(their embeds within 1e-4 of JAX's). Also a resume through
`--canvas_resume_dir`, `embed` against JAX's `precompute_embeds`,
skip-if-exists, the caption and negative-prompt notices, and every flag
and command the port refuses."""
import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch
from PIL import Image

from faithdiff_tpu.config import CLIPTextConfig as JaxCLIPTextConfig
from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.config import (tiny_denoise_encoder_config,
                                  tiny_unet_config, tiny_vae_config)
from faithdiff_tpu.models.clip_text import SDXLTextEncoder as JaxTextEncoder
from faithdiff_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from faithdiff_tpu.models.tokenizer import SDXLTokenizer as JaxSDXLTokenizer
from faithdiff_tpu.pipelines.factory import build_pipeline as jax_build_pipeline
from faithdiff_tpu.training.text_embeds import \
    precompute_embeds as jax_precompute_embeds
from faithdiff_tpu.utils import convert as jconvert
from faithdiff_tpu.utils.image import check_image_size as jax_check_image_size
from faithdiff_tpu_torch import cli
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import vae as tvae
from faithdiff_tpu_torch.models.clip_text import CLIPTextTower
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.pipelines.faithdiff import FaithDiffPipeline
from faithdiff_tpu_torch.utils import convert, convert_cli
from faithdiff_tpu_torch.utils.safetensors import load_file

STEPS = 2
IMG_HW = (15, 31)          # x2 -> 30 x 62, padded to 32 x 64 and cropped back
CAPTION = "The image shows a red cat on the mat. The cat sleeps. It is late."


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_numpy_state_dict(module, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.ndim >= 2:
            x /= np.sqrt(np.prod(v.shape[1:]))
        else:
            x = 0.1 * x if k.endswith("bias") else 1 + 0.1 * x
        out[k] = x
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX params (made through the JAX package's own conversion from
    numpy weights), their JAX export in the reference layout on disk, and
    the port's convert_cli run over it."""
    root = tmp_path_factory.mktemp("cli")
    unet, extras = jconvert.split_faithdiff_bin(_random_numpy_state_dict(
        UNet2DConditionModel(tcfg.tiny_unet_config()), 0))
    params = dict(
        unet={"params": jconvert.convert_faithdiff_unet(unet, extras)},
        vae={"params": jconvert.convert_vae(_random_numpy_state_dict(
            tvae.AutoencoderKL(tcfg.tiny_vae_config()), 1))},
        denoise_encoder={"params": jconvert.convert_denoise_encoder(
            _random_numpy_state_dict(
                tvae.DenoiseEncoder(tcfg.tiny_denoise_encoder_config()), 2))})

    unet_ref = jconvert.export_to_torch_state_dict(params["unet"]["params"])
    core, extras = jconvert.split_faithdiff_bin(unet_ref)
    de_ref = jconvert.export_to_torch_state_dict(
        params["denoise_encoder"]["params"]["encoder"])
    fd_bin = {f"{ns}.{k}": torch.from_numpy(v.copy())
              for ns, sd in extras.items() for k, v in sd.items()}
    fd_bin.update({f"denoise_encoder.{k}": torch.from_numpy(v.copy())
                   for k, v in de_ref.items()})
    # the tiny text towers in transformers' layout, position_ids included
    towers = {}
    for i, (tower, cfg) in enumerate(zip(convert.TEXT_TOWERS,
                                         tcfg.tiny_text_encoder_configs())):
        towers[tower] = _random_numpy_state_dict(CLIPTextTower(cfg), 3 + i)
        params[tower] = jconvert.convert_clip_text(
            towers[tower], with_projection=cfg.projection_dim is not None)
    for sub, sd in (("sdxl/unet", core), ("vae", jconvert.export_to_torch_state_dict(
            params["vae"]["params"])),
            *((f"sdxl/{t}", dict(sd, **{"text_model.embeddings.position_ids":
                                        np.arange(77)[None]}))
              for t, sd in towers.items())):
        os.makedirs(root / sub)
        safetensors.numpy.save_file(
            {k: np.ascontiguousarray(v) for k, v in sd.items()},
            str(root / sub / "diffusion_pytorch_model.safetensors"))
    torch.save(fd_bin, root / "FaithDiff.bin")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = convert_cli.main(["--sdxl_dir", str(root / "sdxl"),
                               "--faithdiff_bin", str(root / "FaithDiff.bin"),
                               "--vae_dir", str(root / "vae"),
                               "--out_dir", str(root / "ckpt")])
    assert rc == 0
    return dict(root=root, dir=str(root / "ckpt"), params=params,
                printed=out.getvalue(), unet_ref=unet_ref, de_ref=de_ref)


@pytest.mark.parametrize("model", ["unet", "vae", "denoise_encoder"])
def test_convert_cli_writes_port_state_dicts(ckpt, model):
    got = load_file(os.path.join(ckpt["dir"], model, convert_cli.MODEL_FILE))
    want = convert.state_dict_from_flax(ckpt["params"][model])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_cli_writes_the_text_towers(ckpt):
    """`text_encoders/` holds both towers under their directory names, the
    `position_ids` buffer dropped: exactly the flax carry of the params
    that the JAX package's `convert_clip_text` makes of the same files."""
    got = load_file(os.path.join(ckpt["dir"], "text_encoders", convert_cli.MODEL_FILE))
    want = convert.clip_text_state_dict_from_flax(
        {t: ckpt["params"][t] for t in convert.TEXT_TOWERS})
    assert sorted(got) == sorted(want)
    assert not any(k.endswith("position_ids") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_cli_export_gives_faithdiff_bin(ckpt, tmp_path):
    """export_main writes FaithDiff.bin as the JAX export does: core UNet,
    fusion modules and `denoise_encoder.*`."""
    out = str(tmp_path / "FaithDiff.bin")
    with contextlib.redirect_stdout(io.StringIO()):
        assert convert_cli.export_main(["--checkpoint_dir", ckpt["dir"],
                                        "--out", out]) == 0
    got = convert.load_torch_bin(out)
    want = dict(ckpt["unet_ref"])
    want.update({f"denoise_encoder.{k}": v for k, v in ckpt["de_ref"].items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)


def _restore(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["restore", "--tiny", "--device", "cpu",
                       "--num_inference_steps", str(STEPS)] + argv)
    assert rc == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def jax_side(ckpt):
    """The JAX CLI's steps on a seeded PNG: LANCZOS x2 by PIL, replicate
    pad, the JAX pipeline with the CLI's defaults (seed 42, zero embeds),
    crop back; and JAX's posterior noise, split(PRNGKey(42), 3)[2], which
    both sides then take."""
    img = np.random.default_rng(7).integers(0, 256, IMG_HW + (3,), dtype=np.uint8)
    h, w = IMG_HW
    up = np.asarray(Image.fromarray(img).resize((2 * w, 2 * h), Image.LANCZOS))
    padded, w0, h0, _, _ = jax_check_image_size(up)
    p = ckpt["params"]
    jpipe = jax_build_pipeline(
        unet_config=tiny_unet_config(), vae_config=tiny_vae_config(),
        denoise_encoder_config=tiny_denoise_encoder_config(),
        pipeline_config=JaxPipelineConfig(num_inference_steps=STEPS),
        unet_params=p["unet"], vae_params=p["vae"],
        denoise_encoder_params=p["denoise_encoder"], dtype=jnp.float32)

    def run(pe, pooled, image=None, **kw):
        """The JAX pipeline on `padded`, or on another image of this size
        taken through the same LANCZOS x2 and pad."""
        src = padded
        if image is not None:
            src = jax_check_image_size(np.asarray(
                Image.fromarray(image).resize((2 * w, 2 * h), Image.LANCZOS)))[0]
        return np.asarray(jpipe(src, pe, pooled, seed=42, output_type="uint8",
                                noise_source="torch", **kw))[:h0, :w0]

    key = jax.random.split(jax.random.PRNGKey(42), 3)[2]
    lh, lw = padded.shape[0] // 8, padded.shape[1] // 8
    noise = np.asarray(jax.random.normal(key, (1, lh, lw, 4), jnp.float32))
    return dict(img=img, run=run, zero=run(jnp.zeros((1, 77, 64)), jnp.zeros((1, 64))),
                noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))


def test_restore_matches_jax_pipeline(ckpt, jax_side, tmp_path, monkeypatch):
    os.makedirs(tmp_path / "in")
    Image.fromarray(jax_side["img"]).save(tmp_path / "in" / "a.png")
    want = jax_side["zero"]
    monkeypatch.setattr(tvae, "posterior_noise", lambda shape, generator, device:
                        jax_side["noise"])
    printed = _restore(["--img_dir", str(tmp_path / "in"),
                        "--save_dir", str(tmp_path / "out"),
                        "--checkpoint_dir", ckpt["dir"]])
    assert "restored a ->" in printed and "pipeline_s=" in printed
    got = np.asarray(Image.open(tmp_path / "out" / "a.png"))
    h, w = IMG_HW
    assert got.shape == (2 * h, 2 * w, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_restore_of_a_jpeg_matches_jax_and_its_png(ckpt, jax_side, tmp_path,
                                                    monkeypatch):
    """A JPEG in `--img_dir` is decoded as Pillow decodes it (the JAX CLI's
    `Image.open(p).convert("RGB")`): its restore is within 1 uint8 level of
    the JAX pipeline's on Pillow's decode, as a PNG's is (the two pipelines
    agree to a level, not to the bit), and its PNG is the one the same
    pixels written as a PNG give, byte for byte."""
    for d in ("in", "png"):
        os.makedirs(tmp_path / d)
    Image.fromarray(jax_side["img"]).save(tmp_path / "in" / "a.jpg", quality=90)
    decoded = np.asarray(Image.open(tmp_path / "in" / "a.jpg").convert("RGB"))
    Image.fromarray(decoded).save(tmp_path / "png" / "a.png")
    monkeypatch.setattr(tvae, "posterior_noise", lambda shape, generator, device:
                        jax_side["noise"])
    for d in ("in", "png"):
        printed = _restore(["--img_dir", str(tmp_path / d),
                            "--save_dir", str(tmp_path / f"out_{d}"),
                            "--checkpoint_dir", ckpt["dir"]])
        assert "restored a ->" in printed
    data = (tmp_path / "out_in" / "a.png").read_bytes()
    assert data == (tmp_path / "out_png" / "a.png").read_bytes()
    got = np.asarray(Image.open(io.BytesIO(data)))
    want = jax_side["run"](jnp.zeros((1, 77, 64)), jnp.zeros((1, 64)), image=decoded)
    assert got.shape == want.shape == (2 * IMG_HW[0], 2 * IMG_HW[1], 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _write_tokenizer_dirs(root):
    """SDXL-layout tokenizer dirs whose ids fit the tiny towers' vocab of
    128: `!`, a-z, a-z + `</w>`, six merges, BOS 126, EOS 127;
    `tokenizer_2` pads with `!`. Other symbols take UNK (EOS)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = ["!"] + list(letters) + [c + "</w>" for c in letters]
    merges = ["c a", "ca t</w>", "r e", "re d</w>", "t h", "th e</w>"]
    vocab += [m.replace(" ", "") for m in merges]
    ids = {t: i for i, t in enumerate(vocab)}
    ids.update({"<|startoftext|>": 126, "<|endoftext|>": 127})
    for name, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump(ids, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
            json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                       "unk_token": "<|endoftext|>", "pad_token": pad}, f)
    return root


def _jax_towers(ckpt):
    """The JAX package's tiny SDXLTextEncoder over the params its own
    `convert_clip_text` made of the tower files."""
    c1, c2 = (JaxCLIPTextConfig(**dataclasses.asdict(c))
              for c in tcfg.tiny_text_encoder_configs())
    enc = JaxTextEncoder(config_1=c1, config_2=c2)
    params = {"params": {t: ckpt["params"][t] for t in convert.TEXT_TOWERS}}
    return lambda ids_1, ids_2: enc.apply(params, jnp.asarray(ids_1),
                                          jnp.asarray(ids_2))


def test_restore_with_tokenizer_dir_matches_jax(ckpt, jax_side, tmp_path, monkeypatch):
    """`--tokenizer_dir` with `text_encoders/`: the trimmed caption of
    `--json_dir` and `--negative_prompt` through the port's BPE and tiny
    towers give JAX's embeds (transformers' tokenizer, JAX's towers)
    within 1e-4, and the PNG is within 1 uint8 level of the JAX pipeline
    given those embeds, and differs from the zero-embed restore."""
    tok = _write_tokenizer_dirs(str(tmp_path / "tok"))
    os.makedirs(tmp_path / "in")
    os.makedirs(tmp_path / "json")
    Image.fromarray(jax_side["img"]).save(tmp_path / "in" / "a.png")
    with open(tmp_path / "json" / "a.json", "w") as f:
        json.dump({"caption": CAPTION}, f)
    jtok = JaxSDXLTokenizer(os.path.join(tok, "tokenizer"),
                            os.path.join(tok, "tokenizer_2"))
    encode = _jax_towers(ckpt)
    pe, pooled = encode(*jtok(cli.trim_caption(CAPTION)))
    npe, npooled = encode(*jtok("the red cat!"))
    want = jax_side["run"](pe, pooled, negative_prompt_embeds=npe,
                           negative_pooled_prompt_embeds=npooled)

    seen = {}
    call = FaithDiffPipeline.__call__

    def spy(self, lr_image, prompt_embeds, pooled_prompt_embeds, **kw):
        seen.update(kw, pe=prompt_embeds, pooled=pooled_prompt_embeds)
        return call(self, lr_image, prompt_embeds, pooled_prompt_embeds, **kw)

    monkeypatch.setattr(FaithDiffPipeline, "__call__", spy)
    monkeypatch.setattr(tvae, "posterior_noise", lambda shape, generator, device:
                        jax_side["noise"])
    printed = _restore(["--img_dir", str(tmp_path / "in"),
                        "--save_dir", str(tmp_path / "out"),
                        "--checkpoint_dir", ckpt["dir"], "--tokenizer_dir", tok,
                        "--json_dir", str(tmp_path / "json"),
                        "--negative_prompt", "the red cat!"])
    assert "not used" not in printed and "WARNING" not in printed
    for name, ref in (("pe", pe), ("pooled", pooled),
                      ("negative_prompt_embeds", npe),
                      ("negative_pooled_prompt_embeds", npooled)):
        np.testing.assert_allclose(seen[name].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    got = np.asarray(Image.open(tmp_path / "out" / "a.png"))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - jax_side["zero"].astype(int)).max() > 1


def test_restore_resumes_through_canvas_resume_dir(ckpt, tmp_path, monkeypatch):
    """A 20-tile restore (96x80 px at --upscale 2 and a 64 px tile: a 24x20
    latent, tiles of 8) keeps each step's canvas under
    `--canvas_resume_dir/<stem>/`, in UNet calls of `cli.TILE_CHUNK` tiles;
    with the output and the last canvas gone, a re-run makes only the last
    step's calls and writes the same PNG."""
    calls = []
    build = cli.load_checkpointed_pipeline

    def watched(args):
        pipe = build(args)
        pipe.unet.register_forward_pre_hook(lambda m, a: calls.append(a[0].shape[0]))
        return pipe

    monkeypatch.setattr(cli, "load_checkpointed_pipeline", watched)
    img = np.random.default_rng(9).integers(0, 256, (96, 80, 3), dtype=np.uint8)
    os.makedirs(tmp_path / "in")
    Image.fromarray(img).save(tmp_path / "in" / "a.png")
    argv = ["--img_dir", str(tmp_path / "in"), "--save_dir", str(tmp_path / "out"),
            "--checkpoint_dir", ckpt["dir"], "--latent_tiled_size", "64",
            "--canvas_resume_dir", str(tmp_path / "resume")]
    _restore(argv)
    c = cli.TILE_CHUNK
    per_step = [2 * min(c, 20 - lo) for lo in range(0, 20, c)]
    assert calls == per_step * STEPS
    canvases = sorted(os.listdir(tmp_path / "resume" / "a"))
    assert canvases == ["canvas_meta.json"] + [f"canvas_step{i:04d}.npy"
                                               for i in range(STEPS)]
    first = (tmp_path / "out" / "a.png").read_bytes()
    os.remove(tmp_path / "out" / "a.png")
    os.remove(tmp_path / "resume" / "a" / f"canvas_step{STEPS - 1:04d}.npy")
    calls.clear()
    _restore(argv)
    assert calls == per_step
    assert (tmp_path / "out" / "a.png").read_bytes() == first


@pytest.mark.parametrize("tokenizer", ["hash", "bpe"])
def test_embed_matches_jax_precompute(ckpt, tmp_path, tokenizer):
    """`embed --tiny --text_encoder_dir <ckpt>/text_encoders` writes
    `<stem>.npz` and `__null__.npz` with JAX's keys, shapes and dtype,
    within 1e-5 of JAX's `precompute_embeds` on the same captions, towers
    and tokenizer (the hash tokenizer, or transformers' on the same
    tokenizer dirs)."""
    caps = tmp_path / "caps"
    os.makedirs(caps)
    (caps / "a.txt").write_text(CAPTION)
    (caps / "b.json").write_text(json.dumps({"caption": "The image shows the cat."}))
    argv = ["embed", "--tiny", "--device", "cpu", "--caption_dir", str(caps),
            "--save_dir", str(tmp_path / "port"),
            "--text_encoder_dir", os.path.join(ckpt["dir"], "text_encoders")]
    if tokenizer == "bpe":
        tok = _write_tokenizer_dirs(str(tmp_path / "tok"))
        argv += ["--tokenizer_dir", tok]
        jtok = JaxSDXLTokenizer(os.path.join(tok, "tokenizer"),
                                os.path.join(tok, "tokenizer_2"))
    else:
        jtok = JaxHashTokenizer(vocab_size=128)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    assert "wrote 3 embedding files" in out.getvalue()
    files = sorted(str(p) for p in caps.iterdir())
    assert jax_precompute_embeds(files, str(tmp_path / "jax"), jtok,
                                 _jax_towers(ckpt)) == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "__null__.npz", "a.npz", "b.npz"]
    for name in names:
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(got) == sorted(want) == ["pooled_embeds", "prompt_embeds"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_restore_skips_existing_and_says_what_it_ignores(tmp_path):
    """Skip-if-exists on the output name; a JSON caption and a negative
    prompt are reported as unused (no text towers), not dropped silently."""
    img = np.random.default_rng(8).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    os.makedirs(tmp_path / "in")
    os.makedirs(tmp_path / "json")
    Image.fromarray(img).save(tmp_path / "in" / "b.png")
    with open(tmp_path / "json" / "b.json", "w") as f:
        json.dump({"caption": "The image shows a red house. It has a door. "
                              "And a cat."}, f)
    argv = ["--img_dir", str(tmp_path / "in"), "--save_dir", str(tmp_path / "out"),
            "--json_dir", str(tmp_path / "json"), "--negative_prompt", "blur",
            "--start_point", "noise"]
    printed = _restore(argv)
    assert "WARNING: --negative_prompt ignored" in printed
    assert "caption of b not used" in printed
    assert repr(cli.trim_caption("The image shows a red house. It has a door. "
                                 "And a cat.")) in printed
    before = os.stat(tmp_path / "out" / "b.png").st_mtime_ns
    assert "skip b" in _restore(argv)
    assert os.stat(tmp_path / "out" / "b.png").st_mtime_ns == before


# `--tile_devices N` runs under torchrun with WORLD_SIZE == N (served, see
# test_torch_parallel.py): a mismatch, with or without `--use_fp8`, is
# refused before any weight is read, as a JPEG the decoder does not take is
# (a CMYK one: ROADMAP §1.1)
@pytest.mark.parametrize("flags", [
    ["--use_fp8", "--tile_devices", "4"], ["--tile_devices", "2"], ["jpeg"]],
    ids=lambda f: f[0])
def test_restore_refuses_what_it_does_not_serve(tmp_path, flags, monkeypatch):
    os.makedirs(tmp_path / "in")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "in" / "a.png")
    error, match = ValueError, r"--tile_devices \d under WORLD_SIZE=\d"
    if flags == ["jpeg"]:
        Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(
            tmp_path / "in" / "c.jpg")
        flags, error, match = [], ValueError, r"c\.jpg: a CMYK .*ROADMAP §1\.1"
    elif flags == ["--tile_devices", "2"]:
        monkeypatch.setenv("WORLD_SIZE", "3")     # torchrun started 3
    with pytest.raises(error, match=match):
        cli.main(["restore", "--tiny", "--device", "cpu", "--img_dir",
                  str(tmp_path / "in"), "--save_dir", str(tmp_path / "out")]
                 + flags)
    assert not os.path.exists(tmp_path / "out")


# what each command refuses before anything is built: `train` under
# torchrun (WORLD_SIZE=2, served) a global batch its ranks do not split;
# `metrics` a truncated JPEG, before any weights load or the device is
# asked for
UNSERVED = {"train": (["--output_dir", "{dir}/run", "--device", "cpu",
                       "--train_batch_size", "3"], ValueError, "does not split"),
            "metrics": (["--sr_dir", "{dir}"], ValueError, r"a\.jpg: truncated JPEG")}


@pytest.mark.parametrize("command", ["train", "metrics"])
def test_commands_not_ported_raise(command, monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff")
    argv, error, match = UNSERVED[command]
    with pytest.raises(error, match=match):
        cli.main([command] + [a.replace("{dir}", str(tmp_path)) for a in argv])
    assert not os.path.exists(tmp_path / "run")


def test_unknown_command_prints_usage():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["resize"]) == 1
    assert "restore|caption|embed|train|metrics" in out.getvalue()
