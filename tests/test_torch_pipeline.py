"""The restore path end to end: the port's tiny pipeline against the JAX
package's, with the same weights (made with numpy, carried by
`state_dict_from_flax`), on a 2-tile input (64x96 px at tile_size 64,
latent tiles of 8 at offsets (0, 0) and (0, 4)) over 4 Euler steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.config import (tiny_denoise_encoder_config,
                                  tiny_unet_config, tiny_vae_config)
from faithdiff_tpu.models.unet import UNet2DConditionModel as FlaxUNet
from faithdiff_tpu.models.vae import AutoencoderKL as FlaxVAE
from faithdiff_tpu.models.vae import DenoiseEncoder as FlaxDenoiseEncoder
from faithdiff_tpu.pipelines.factory import \
    build_tiny_pipeline as jax_build_tiny_pipeline
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import vae as torch_vae
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import random_params

SEED = 3
H, W = 64, 96


@pytest.fixture(scope="module")
def pipes():
    z = jnp.zeros
    unet = random_params(FlaxUNet(config=tiny_unet_config()), 0,
                         z((2, 8, 8, 4)), z((2,)), z((2, 77, 64)), z((2, 64)),
                         z((2, 6)), z((2, 8, 8, 64)))
    vae = random_params(FlaxVAE(config=tiny_vae_config()), 1, z((1, 64, 64, 3)))
    de = random_params(FlaxDenoiseEncoder(config=tiny_denoise_encoder_config()),
                       2, z((1, 64, 64, 3)))
    jpipe = jax_build_tiny_pipeline(
        pipeline_config=JaxPipelineConfig(tile_size=64, num_inference_steps=4),
        unet_params=unet, vae_params=vae, denoise_encoder_params=de)
    tpipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=4),
        unet_state_dict=state_dict_from_flax(unet),
        vae_state_dict=state_dict_from_flax(vae),
        denoise_encoder_state_dict=state_dict_from_flax(de), device="cpu")
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    pe = rng.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 64)).astype(np.float32)
    return jpipe, tpipe, (img, pe, pooled)


def _run_both(pipes, **kw):
    """Each side's denoise once, to latents (NHWC numpy)."""
    jpipe, tpipe, (img, pe, pooled) = pipes
    want = jpipe(img, jnp.asarray(pe), jnp.asarray(pooled), seed=SEED,
                 output_type="latent", noise_source="torch", **kw)
    _build.launches.clear()
    got = tpipe(img, pe, pooled, seed=SEED, output_type="latent", **kw)
    assert sum(_build.launches.values()) == 0     # CPU: plain versions only
    return np.asarray(want), got.numpy()


def _decode_both(pipes, want_latents, got_latents, output_type):
    """The "np" / "uint8" output of the run that gave these latents: each
    pipeline's own decode of them (the JAX `__call__` returns
    `_jit_postprocess(vae_params, latents, lr[None], ...)[0]`, the port's
    `_decode`, which `decode` runs)."""
    jpipe, tpipe, (img, _, _) = pipes
    want = jpipe._jit_postprocess(jpipe.vae_params, jnp.asarray(want_latents),
                                  jnp.asarray(img)[None],
                                  color_fix=jpipe.config.color_fix,
                                  to_uint8=output_type == "uint8")[0]
    _build.launches.clear()
    got = tpipe.decode(got_latents, img, output_type=output_type)
    assert sum(_build.launches.values()) == 0
    return np.asarray(want), got


def test_start_point_noise(pipes):
    """Same CPU torch.Generator latents on both sides: latents, float and
    uint8 images agree. fp32 throughout; the differences are summation
    order through 4 steps of CFG 5, and uint8 rounding may flip by 1."""
    want_lat, got_lat = _run_both(pipes, start_point="noise")
    assert got_lat.shape == (1, H // 8, W // 8, 4)
    np.testing.assert_allclose(got_lat, want_lat, rtol=1e-4, atol=1e-4)
    want, got = _decode_both(pipes, want_lat, got_lat, "np")
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    want, got = _decode_both(pipes, want_lat, got_lat, "uint8")
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_start_point_lr(pipes, monkeypatch):
    """VAE encode + DDPM noise to t=999: both sides get JAX's posterior
    noise, drawn from split(PRNGKey(seed), 3)[2] as the JAX pipeline does."""
    key = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    noise = np.asarray(jax.random.normal(key, (1, H // 8, W // 8, 4),
                                         jnp.float32)).transpose(0, 3, 1, 2)

    def jax_noise(shape, generator, device):
        assert tuple(shape) == noise.shape
        return torch.from_numpy(noise.copy()).to(device)

    monkeypatch.setattr(torch_vae, "posterior_noise", jax_noise)
    want_lat, got_lat = _run_both(pipes, start_point="lr")
    np.testing.assert_allclose(got_lat, want_lat, rtol=1e-4, atol=1e-4)
    want, got = _decode_both(pipes, want_lat, got_lat, "uint8")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
