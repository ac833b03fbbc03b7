"""The tiled VAE option against the JAX package: `blend_v` / `blend_h`,
`tiled_apply` (and its batched grid walk), the streaming color fix, and
the tiny pipeline under `use_tiled_vae` end to end (denoise encoder, VAE
encode and decode over tiles, ragged edge tiles, the fix streamed by
windows) within 1 uint8 level of JAX's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.models import vae as jvae
from faithdiff_tpu.pipelines.factory import \
    build_tiny_pipeline as jax_build_tiny_pipeline
from faithdiff_tpu.utils import convert as jconvert
from faithdiff_tpu.utils.color_fix import \
    streaming_color_fix as jax_streaming_color_fix
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import vae as tvae
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils.color_fix import streaming_color_fix
from port_parity import nchw, nhwc

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("extent", [0, 3, 8, 40])
@pytest.mark.parametrize("axis", ["v", "h"])
def test_blend_matches_jax(extent, axis):
    # the blended tiles share the other axis' extent
    a = RNG.standard_normal((2, 9, 12, 3) if axis == "v" else (2, 10, 11, 3))
    b = RNG.standard_normal((2, 10, 12, 3)).astype(np.float32)
    a = a.astype(np.float32)
    jfn, tfn = ((jvae.blend_v, tvae.blend_v) if axis == "v"
                else (jvae.blend_h, tvae.blend_h))
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), extent))
    got = nhwc(tfn(nchw(a), nchw(b), extent))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _encode_like(lib):
    """An 8x average pool and a pointwise map (scale 1/8), NHWC in JAX."""
    if lib == "jax":
        return lambda x: jnp.tanh(x.reshape(x.shape[0], x.shape[1] // 8, 8,
                                            x.shape[2] // 8, 8, -1).mean((2, 4)))
    return lambda x: torch.tanh(torch.nn.functional.avg_pool2d(x, 8))


def _decode_like(lib):
    """An 8x nearest upsample and a position-free pointwise map (scale 8)."""
    if lib == "jax":
        return lambda z: jnp.sin(jnp.repeat(jnp.repeat(z, 8, 1), 8, 2))
    return lambda z: torch.sin(z.repeat_interleave(8, 2).repeat_interleave(8, 3))


TILED_CASES = {"encode": ((1, 96, 136, 3), 64), "decode": ((1, 12, 17, 4), 8)}


@functools.lru_cache(maxsize=None)
def _tiled_case(kind):
    """(input, JAX's tiled_apply of it): ragged edge tiles on both axes."""
    shape, tile = TILED_CASES[kind]
    x = np.random.default_rng(len(kind)).standard_normal(shape).astype(np.float32)
    make, scale = (_encode_like, 1 / 8) if kind == "encode" else (_decode_like, 8.0)
    return x, np.asarray(jvae.tiled_apply(make("jax"), jnp.asarray(x), tile,
                                          0.25, scale))


@pytest.mark.parametrize("kind", sorted(TILED_CASES))
@pytest.mark.parametrize("batch", [0, 1, 2, 5])
def test_tiled_apply_matches_jax(kind, batch):
    """Grid, ragged edge tiles, seam blends and crops at the VAE's overlap
    0.25; `batch` > 0 walks the grid in same-shape groups of `batch`."""
    x, want = _tiled_case(kind)
    tile = TILED_CASES[kind][1]
    make, scale = (_encode_like, 1 / 8) if kind == "encode" else (_decode_like, 8.0)
    tfn = make("torch")
    got = nhwc(tvae.tiled_apply(tfn, nchw(x), tile, 0.25, scale,
                                batched_fn=tfn if batch else None, batch=batch))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["wavelet", "adain", "nofix"])
@pytest.mark.parametrize("to_uint8", [False, True])
def test_streaming_color_fix_matches_jax(mode, to_uint8):
    """Windows of 40 px with a 32-px halo, ragged at the edges (one window
    per image runs in the pipeline test); the decode output in [-1, 1]
    (`denorm`), a uint8 source; fp32."""
    hw, tile = (100, 150), 40
    tgt = RNG.uniform(-1.1, 1.1, (1,) + hw + (3,)).astype(np.float32)
    src = RNG.integers(0, 256, hw + (3,), dtype=np.uint8)
    want = jax_streaming_color_fix(jnp.asarray(tgt), jnp.asarray(src), mode=mode,
                                   tile=tile, to_uint8=to_uint8, denorm=True)
    got = streaming_color_fix(nchw(tgt), torch.from_numpy(src), mode=mode,
                              tile=tile, to_uint8=to_uint8, denorm=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    if to_uint8:    # a value at a rounding boundary may land on either side
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def random_state_dict(module, seed):
    """numpy-made weights for a port module: matrices and kernels
    N(0, 1/fan_in), biases 0.1 N(0, 1), norm scales 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.ndim >= 2:
            x /= np.sqrt(np.prod(v.shape[1:]))
        else:
            x = 0.1 * x if k.endswith("bias") else 1 + 0.1 * x
        out[k] = torch.from_numpy(x)
    return out


# one row of encode and denoise-encoder tiles (32 x 64, stride 48); latents
# 4 x 14: decode tiles 4 x (8, 8, 2); latent tiles (4, 8) at offsets 0, 4, 6
H, W = 32, 112


def test_tiled_pipeline_matches_jax(monkeypatch):
    """The tiny pipeline under use_tiled_vae on a 32x112 input (2 encode
    and denoise-encoder tiles, 3 decode tiles with a ragged edge, 3 latent
    tiles), 2 Euler steps, against JAX's with the same weights (the port's
    random ones, through the JAX package's own conversion) and noise."""
    unet_sd = random_state_dict(UNet2DConditionModel(tcfg.tiny_unet_config()), 0)
    vae_sd = random_state_dict(tvae.AutoencoderKL(tcfg.tiny_vae_config()), 1)
    de_sd = random_state_dict(
        tvae.DenoiseEncoder(tcfg.tiny_denoise_encoder_config()), 2)
    np_sd = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    core, extras = jconvert.split_faithdiff_bin(np_sd(unet_sd))
    jpipe = jax_build_tiny_pipeline(
        pipeline_config=JaxPipelineConfig(tile_size=64, num_inference_steps=2,
                                          use_tiled_vae=True),
        unet_params={"params": jconvert.convert_faithdiff_unet(core, extras)},
        vae_params={"params": jconvert.convert_vae(np_sd(vae_sd))},
        denoise_encoder_params={
            "params": jconvert.convert_denoise_encoder(np_sd(de_sd))})
    tpipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=2,
                                            use_tiled_vae=True),
        unet_state_dict=unet_sd, vae_state_dict=vae_sd,
        denoise_encoder_state_dict=de_sd, device="cpu")
    img = RNG.integers(0, 256, (H, W, 3), dtype=np.uint8)
    pe = RNG.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = RNG.standard_normal((1, 64)).astype(np.float32)
    want = jpipe(img, jnp.asarray(pe), jnp.asarray(pooled), seed=5,
                 output_type="uint8", noise_source="torch")

    # JAX's posterior noise, drawn from split(PRNGKey(seed), 3)[2]
    key = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    noise = np.asarray(jax.random.normal(key, (1, H // 8, W // 8, 4),
                                         jnp.float32)).transpose(0, 3, 1, 2)
    monkeypatch.setattr(tvae, "posterior_noise",
                        lambda shape, generator, device: torch.from_numpy(noise.copy()))
    calls = {"decode": 0}
    decode = tpipe.vae.decode
    monkeypatch.setattr(tpipe.vae, "decode",
                        lambda z: calls.__setitem__("decode", calls["decode"] + 1)
                        or decode(z))
    _build.launches.clear()
    got = tpipe(img, pe, pooled, seed=5, output_type="uint8")
    assert sum(_build.launches.values()) == 0       # CPU: plain versions only
    assert calls["decode"] == 3                     # tiles of 8, 8, 2 columns
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
