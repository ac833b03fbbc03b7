"""`tile_chunk` and lazy LQ tiles: the port's tiny pipeline against the
JAX package's `build_tiny_pipeline(tile_chunk=...)` with the same weights
(numpy-made, carried by `state_dict_from_flax`), on a 5-tile input (64x192
px at tile_size 64: latent tiles of 8 at column offsets 0, 4, 8, 12, 16),
so that chunks of 2 leave a ragged last chunk in the port and a padded one
in JAX. `noise_source="torch"`, and both sides take JAX's VAE posterior
noise. fp32 on the CPU: latents within 1e-4 of JAX; chunked within
1e-5 * max|latents| of unchunked inside each package (the latents reach
6.5 here, and 3 steps of CFG 5 carry the fp32 summation-order differences
of UNet calls at other batch sizes: 1.5e-5 at most in both packages)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.pipelines.factory import \
    build_tiny_pipeline as jax_build_tiny_pipeline
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models import vae as torch_vae
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import jax_posterior_noise, tiny_restore_params

SEED, STEPS = 5, 3
H, W = 64, 192
CHUNKS = (None, 2, 3)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """NHWC latents of both packages at every chunk, and the model rows of
    each of the port's UNet calls."""
    unet, vae, de = tiny_restore_params()
    jpipe = jax_build_tiny_pipeline(
        pipeline_config=JaxPipelineConfig(tile_size=64, num_inference_steps=STEPS),
        unet_params=unet, vae_params=vae, denoise_encoder_params=de)
    tpipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=STEPS),
        unet_state_dict=state_dict_from_flax(unet),
        vae_state_dict=state_dict_from_flax(vae),
        denoise_encoder_state_dict=state_dict_from_flax(de), device="cpu")
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    pe = rng.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 64)).astype(np.float32)
    noise = jax_posterior_noise(SEED, H // 8, W // 8)
    rows = {}
    hook = tpipe.unet.register_forward_pre_hook(
        lambda m, args: rows[tpipe.tile_chunk].append(
            (args[0].shape[0], args[4].clone(), args[5].shape[0])))
    orig = torch_vae.posterior_noise
    torch_vae.posterior_noise = lambda shape, generator, device: noise
    out = {}
    try:
        for c in CHUNKS:
            jpipe.tile_chunk = tpipe.tile_chunk = c
            rows[c] = []
            out["jax", c] = np.asarray(jpipe(
                img, jnp.asarray(pe), jnp.asarray(pooled), seed=SEED,
                output_type="latent", noise_source="torch", guidance_rescale=0.3))
            out["port", c] = tpipe(img, pe, pooled, seed=SEED, output_type="latent",
                                   guidance_rescale=0.3).numpy()
    finally:
        torch_vae.posterior_noise = orig
        hook.remove()
    return dict(out=out, rows=rows, jpipe=jpipe, tpipe=tpipe, vae=vae, img=img)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_latents_match_jax(runs, chunk):
    got, want = runs["out"]["port", chunk], runs["out"]["jax", chunk]
    assert got.shape == (1, H // 8, W // 8, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("chunk", [2, 3])
def test_chunked_matches_unchunked(runs, package, chunk):
    ref = runs["out"][package, None]
    err = np.abs(runs["out"][package, chunk] - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("chunk", CHUNKS)
def test_unet_calls_hold_at_most_a_chunk(runs, chunk):
    """Every UNet call holds at most `chunk` tiles' CFG pairs (a chunk of 2
    never more than 4 rows, LQ tiles included: the duplicated LQ batch of
    all tiles is never built), the last chunk ragged; each tile's pair is
    adjacent (the same time ids on rows 2k and 2k+1), tile-major."""
    calls = runs["rows"][chunk]
    per_step = {None: [10], 2: [4, 4, 2], 3: [6, 4]}[chunk]
    assert [r for r, _, _ in calls] == per_step * STEPS
    assert [lq for _, _, lq in calls] == per_step * STEPS
    offsets = torch.cat([time_ids for _, time_ids, _ in calls[:len(per_step)]])
    assert torch.equal(offsets[0::2], offsets[1::2])
    assert offsets[0::2, 3].tolist() == [0.0, 4.0, 8.0, 12.0, 16.0]


def test_latents_mean_std_match_jax(runs):
    """`latents_mean` / `latents_std` denormalise before the VAE decode,
    as JAX's `_denormalize_latents` does; the decoded image agrees."""
    jpipe, tpipe = runs["jpipe"], runs["tpipe"]
    mean, std = (0.1, -0.2, 0.3, 0.05), (0.9, 1.1, 0.8, 1.2)
    lat = runs["out"]["jax", None]
    try:
        jpipe.latents_mean = tpipe.latents_mean = mean
        jpipe.latents_std = tpipe.latents_std = std
        want_lat = np.asarray(jpipe._denormalize_latents(jnp.asarray(lat)))
        got_lat = tpipe._denormalize_latents(
            torch.from_numpy(lat).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got_lat.numpy(), want_lat, rtol=1e-6, atol=1e-6)
        want = np.asarray(jpipe._postprocess(
            runs["vae"], jnp.asarray(lat), jnp.asarray(runs["img"])[None],
            color_fix="nofix"))[0]
        got = tpipe.decode(lat, runs["img"], color_fix="nofix")
    finally:
        jpipe.latents_mean = tpipe.latents_mean = None
        jpipe.latents_std = tpipe.latents_std = None
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - tpipe.decode(lat, runs["img"], color_fix="nofix")).max() > 1e-3
