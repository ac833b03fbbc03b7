"""Weights in the reference's own layout into the port. The JAX package's
tiny UNet, VAE and denoise-encoder params go out through its
`export_to_torch_state_dict` and `split_faithdiff_bin`, as the
reference's diffusers files and FaithDiff.bin hold them; the port's rules
must give exactly `state_dict_from_flax` of the same params, load into
the port's models strictly, and the port's export must be the exact
inverse. Also `load_torch_bin` (weights only) and the fp16 -> bf16 cast."""
import pickle

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from faithdiff_tpu.config import (tiny_denoise_encoder_config,
                                  tiny_unet_config, tiny_vae_config)
from faithdiff_tpu.models.unet import UNet2DConditionModel as FlaxUNet
from faithdiff_tpu.models.vae import AutoencoderKL as FlaxVAE
from faithdiff_tpu.models.vae import DenoiseEncoder as FlaxDenoiseEncoder
from faithdiff_tpu.utils import convert as jconvert
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.models.vae import AutoencoderKL, DenoiseEncoder
from faithdiff_tpu_torch.pipelines import build_pipeline
from faithdiff_tpu_torch.utils import convert
from port_parity import random_params


@pytest.fixture(scope="module")
def params():
    z = jnp.zeros
    return dict(
        unet=random_params(FlaxUNet(config=tiny_unet_config()), 0,
                           z((2, 8, 8, 4)), z((2,)), z((2, 77, 64)),
                           z((2, 64)), z((2, 6)), z((2, 8, 8, 64))),
        vae=random_params(FlaxVAE(config=tiny_vae_config()), 1,
                          z((1, 64, 64, 3))),
        denoise_encoder=random_params(
            FlaxDenoiseEncoder(config=tiny_denoise_encoder_config()), 2,
            z((1, 64, 64, 3))))


def _torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def reference_files(params):
    """The JAX export in the reference's file layout: the SDXL UNet's core
    keys, FaithDiff.bin (fusion modules + `denoise_encoder.*`, plus an
    `agg_net` the models do not have) and the VAE."""
    unet_ref = jconvert.export_to_torch_state_dict(params["unet"]["params"])
    core, extras = jconvert.split_faithdiff_bin(unet_ref)
    de_ref = jconvert.export_to_torch_state_dict(
        params["denoise_encoder"]["params"]["encoder"])
    fd_bin = {f"{ns}.{k}": v for ns, sd in extras.items() for k, v in sd.items()}
    fd_bin.update({f"denoise_encoder.{k}": v for k, v in de_ref.items()})
    fd_bin["agg_net.0.weight"] = np.ones((2, 2), np.float32)
    vae_ref = jconvert.export_to_torch_state_dict(params["vae"]["params"])
    return dict(unet=_torch(core), faithdiff_bin=_torch(fd_bin),
                vae=_torch(vae_ref), unet_full=unet_ref, denoise_encoder=de_ref)


def _assert_equal_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].float(), want[k].float()), k


@pytest.mark.parametrize("model", ["unet", "vae", "denoise_encoder"])
def test_reference_files_give_the_flax_carry(params, reference_files, model):
    """reference layout -> port rules == the carry of the JAX params, and
    the result loads strictly into the port's tiny model."""
    files = reference_files
    if model == "unet":
        got = convert.unet_state_dict_from_reference(files["unet"],
                                                     files["faithdiff_bin"])
        module = UNet2DConditionModel(tcfg.tiny_unet_config())
    elif model == "vae":
        got = files["vae"]                 # diffusers names are the port's
        module = AutoencoderKL(tcfg.tiny_vae_config())
    else:
        got = convert.denoise_encoder_state_dict_from_reference(
            files["faithdiff_bin"])
        module = DenoiseEncoder(tcfg.tiny_denoise_encoder_config())
    _assert_equal_sd(got, convert.state_dict_from_flax(params[model]))
    module.load_state_dict(got, strict=True)


def test_faithdiff_bin_core_overrides_base_unet(reference_files):
    """FaithDiff.bin's core keys win over the SDXL UNet's (the reference's
    non-strict load over the base); `agg_net` is dropped."""
    base = {k: v + 1 for k, v in reference_files["unet"].items()}
    key = "conv_in.weight"
    fd_bin = dict(reference_files["faithdiff_bin"],
                  **{key: reference_files["unet"][key]})
    got = convert.unet_state_dict_from_reference(base, fd_bin)
    assert torch.equal(got[key], reference_files["unet"][key])
    assert torch.equal(got["conv_out.weight"], base["conv_out.weight"])
    assert not any(k.startswith("agg_net") for k in got)
    core, extras = convert.split_faithdiff_bin(fd_bin)
    jcore, jextras = jconvert.split_faithdiff_bin(fd_bin)
    assert sorted(core) == sorted(jcore)
    assert {ns: sorted(sd) for ns, sd in extras.items()} == \
        {ns: sorted(sd) for ns, sd in jextras.items()}


def test_export_is_the_inverse(params, reference_files):
    """The port's FaithDiff.bin export of its state dicts is the JAX
    export's layout (core + fusion modules + `denoise_encoder.*`), and
    reading it back gives the same state dicts."""
    unet_sd = convert.state_dict_from_flax(params["unet"])
    de_sd = convert.state_dict_from_flax(params["denoise_encoder"])
    exported = convert.export_faithdiff_bin(unet_sd, de_sd)
    want = dict(reference_files["unet_full"])
    want.update({f"denoise_encoder.{k}": v
                 for k, v in reference_files["denoise_encoder"].items()})
    _assert_equal_sd(exported, _torch(want))
    _assert_equal_sd(convert.unet_state_dict_from_reference({}, exported), unet_sd)
    _assert_equal_sd(convert.denoise_encoder_state_dict_from_reference(exported),
                     de_sd)


class _NotATensor:
    pass


def test_load_torch_bin_takes_weights_only(tmp_path, reference_files):
    sd = reference_files["faithdiff_bin"]
    torch.save(sd, tmp_path / "a.bin")
    _assert_equal_sd(convert.load_torch_bin(str(tmp_path / "a.bin")), sd)
    torch.save({"state_dict": sd}, tmp_path / "b.bin")
    _assert_equal_sd(convert.load_torch_bin(str(tmp_path / "b.bin")), sd)
    torch.save({"w": torch.ones(2), "obj": _NotATensor()}, tmp_path / "c.bin")
    with pytest.raises(pickle.UnpicklingError):
        convert.load_torch_bin(str(tmp_path / "c.bin"))


def test_fp16_files_cast_to_bf16_as_jax_does(reference_files):
    """An fp16 checkpoint (RealVisXL ships fp16) built in bf16: each weight
    is fp16 -> fp32 -> bf16 rounded to nearest even, the JAX cast."""
    vae16 = {k: v.half() for k, v in reference_files["vae"].items()}
    pipe = build_pipeline(
        unet_config=tcfg.tiny_unet_config(), vae_config=tcfg.tiny_vae_config(),
        denoise_encoder_config=tcfg.tiny_denoise_encoder_config(),
        vae_state_dict=vae16, dtype=torch.bfloat16, device="cpu")
    for k, v in pipe.vae.state_dict().items():
        want = jnp.asarray(vae16[k].float().numpy()).astype(jnp.bfloat16)
        got = v.float().numpy().astype(ml_dtypes.bfloat16)
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(np.uint16),
                                      np.asarray(want).view(np.uint16), k)
