"""The port's restore CLI end to end at the tiny configs, on the CPU.

Checkpoints in the reference's layout are made from JAX-package params
(`export_to_torch_state_dict`, split as FaithDiff.bin is): an SDXL dir
with `unet/` and the two text towers, FaithDiff.bin and a VAE dir. The
port's `convert_cli` turns them into its checkpoint dir, and
`cli.main(["restore", "--tiny", ...])` restores a PNG from it, within 1
uint8 level of the JAX package's pipeline with the same params on PIL's
LANCZOS upscale of the same input. Also skip-if-exists, the caption and
negative-prompt notices, and every flag and command the port refuses."""
import contextlib
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

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.config import (tiny_denoise_encoder_config,
                                  tiny_unet_config, tiny_vae_config)
from faithdiff_tpu.pipelines.factory import build_pipeline as jax_build_pipeline
from faithdiff_tpu.utils import convert as jconvert
from faithdiff_tpu.utils.image import check_image_size as jax_check_image_size
from faithdiff_tpu_torch import cli
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import vae as tvae
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.utils import convert, convert_cli
from faithdiff_tpu_torch.utils.safetensors import load_file

STEPS = 2
IMG_HW = (15, 31)          # x2 -> 30 x 62, padded to 32 x 64 and cropped back


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
    for sub, sd in (("sdxl/unet", core), ("vae", jconvert.export_to_torch_state_dict(
            params["vae"]["params"])), ("sdxl/text_encoder", {"w": np.ones(2)}),
            ("sdxl/text_encoder_2", {"w": np.ones(2)})):
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
    assert "text_encoder, text_encoder_2" in ckpt["printed"]
    assert "ROADMAP §1.2" in ckpt["printed"]
    assert not os.path.exists(os.path.join(ckpt["dir"], "text_encoders"))


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


def test_restore_matches_jax_pipeline(ckpt, tmp_path, monkeypatch):
    img = np.random.default_rng(7).integers(0, 256, IMG_HW + (3,), dtype=np.uint8)
    os.makedirs(tmp_path / "in")
    Image.fromarray(img).save(tmp_path / "in" / "a.png")

    # the JAX CLI's steps: LANCZOS x2 by PIL, replicate pad, the pipeline
    # with the CLI's defaults (seed 42), zero embeds, crop back
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
    want = np.asarray(jpipe(padded, jnp.zeros((1, 77, 64)), jnp.zeros((1, 64)),
                            seed=42, output_type="uint8",
                            noise_source="torch"))[:h0, :w0]

    # both sides get JAX's posterior noise, split(PRNGKey(42), 3)[2]
    key = jax.random.split(jax.random.PRNGKey(42), 3)[2]
    lh, lw = padded.shape[0] // 8, padded.shape[1] // 8
    noise = np.asarray(jax.random.normal(key, (1, lh, lw, 4), jnp.float32))
    monkeypatch.setattr(tvae, "posterior_noise", lambda shape, generator, device:
                        torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))
    printed = _restore(["--img_dir", str(tmp_path / "in"),
                        "--save_dir", str(tmp_path / "out"),
                        "--checkpoint_dir", ckpt["dir"]])
    assert "restored a ->" in printed and "pipeline_s=" in printed
    got = np.asarray(Image.open(tmp_path / "out" / "a.png"))
    assert got.shape == (2 * h, 2 * w, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


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


@pytest.mark.parametrize("flags", [
    ["--use_fp8"], ["--canvas_resume_dir", "resume"], ["--tile_devices", "2"],
    ["--tokenizer_dir", "tok"], ["jpeg"]], ids=lambda f: f[0])
def test_restore_refuses_what_it_does_not_serve(tmp_path, flags):
    os.makedirs(tmp_path / "in")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "in" / "a.png")
    if flags == ["jpeg"]:
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "in" / "c.jpg")
        flags = []
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1\.\d"):
        cli.main(["restore", "--tiny", "--device", "cpu", "--img_dir",
                  str(tmp_path / "in"), "--save_dir", str(tmp_path / "out")]
                 + flags)
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("command", ["caption", "embed", "train", "metrics"])
def test_commands_not_ported_raise(command):
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1\.\d"):
        cli.main([command, "--img_dir", "x"])


def test_unknown_command_prints_usage():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["resize"]) == 1
    assert "restore|caption|embed|train|metrics" in out.getvalue()
