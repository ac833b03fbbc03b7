"""The port's schedulers against the JAX package's at 1e-6: Euler with
Karras sigmas (sigmas and fractional timesteps), the ancestral Euler step,
DDIM at eta = 0 and eta > 0, and DDPM's timesteps, step (with and without
`clip_sample`) and v-prediction target, each stochastic step given the
noise JAX draws from its key. Then a tiny restore with Karras sigmas
through both pipelines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu import schedulers as js
from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.config import SchedulerConfig as JaxSchedulerConfig
from faithdiff_tpu.pipelines.factory import \
    build_tiny_pipeline as jax_build_tiny_pipeline
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch import schedulers as ts
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import tiny_restore_params

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (2, 4, 8, 8)


def _cfgs(**kw):
    return JaxSchedulerConfig(**kw), tcfg.SchedulerConfig(**kw)


def _rand(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_noise(key, shape=SHAPE):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("spacing", ["leading", "linspace", "trailing"])
@pytest.mark.parametrize("steps", [1, 4, 20])
def test_karras_sigmas_and_timesteps(spacing, steps):
    jc, tc = _cfgs(use_karras_sigmas=True, timestep_spacing=spacing)
    want = js.EulerDiscreteScheduler(jc).set_timesteps(steps)
    got = ts.EulerDiscreteScheduler(tc).set_timesteps(steps)
    np.testing.assert_allclose(got.sigmas.numpy(), np.asarray(want.sigmas), **TOL)
    np.testing.assert_allclose(got.timesteps.numpy(), np.asarray(want.timesteps),
                               **TOL)
    assert got.init_noise_sigma == pytest.approx(float(want.init_noise_sigma),
                                                 rel=1e-6)


@pytest.mark.parametrize("karras", [False, True])
def test_euler_ancestral_step(karras):
    jc, tc = _cfgs(use_karras_sigmas=karras)
    jsch, tsch = js.EulerAncestralDiscreteScheduler(jc), \
        ts.EulerAncestralDiscreteScheduler(tc)
    jstate, tstate = jsch.set_timesteps(6), tsch.set_timesteps(6)
    x, eps = _rand(0), _rand(1)
    for i in range(6):
        key = jax.random.PRNGKey(10 + i)
        want = jsch.step(jstate, jnp.asarray(eps), i, jnp.asarray(x), key=key)
        got = tsch.step(tstate, torch.from_numpy(eps), i, torch.from_numpy(x),
                        noise=torch.from_numpy(_jax_noise(key)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # no key, no noise: the deterministic part alone
        want = jsch.step(jstate, jnp.asarray(eps), i, jnp.asarray(x))
        got = tsch.step(tstate, torch.from_numpy(eps), i, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        x = np.asarray(want)


def test_euler_ancestral_draws_from_a_generator():
    tsch = ts.EulerAncestralDiscreteScheduler(tcfg.SchedulerConfig())
    state = tsch.set_timesteps(4)
    x, eps = torch.from_numpy(_rand(0)), torch.from_numpy(_rand(1))
    a = tsch.step(state, eps, 1, x, generator=torch.Generator().manual_seed(5))
    b = tsch.step(state, eps, 1, x, noise=torch.randn(
        SHAPE, generator=torch.Generator().manual_seed(5)))
    assert torch.equal(a, b)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("clip", [False, True])
def test_ddim_step(eta, clip):
    jc, tc = _cfgs(clip_sample=clip)
    jsch, tsch = js.DDIMScheduler(jc), ts.DDIMScheduler(tc)
    jstate, tstate = jsch.set_timesteps(5), tsch.set_timesteps(5)
    np.testing.assert_array_equal(tstate.timesteps.numpy(),
                                  np.asarray(jstate.timesteps))
    x, eps = _rand(2), _rand(3)
    for i in range(5):
        key = jax.random.PRNGKey(20 + i)
        want = jsch.step(jstate, jnp.asarray(eps), i, jnp.asarray(x), eta=eta,
                         key=key)
        got = tsch.step(tstate, torch.from_numpy(eps), i, torch.from_numpy(x),
                        eta=eta, noise=torch.from_numpy(_jax_noise(key)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        x = np.asarray(want)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_ddpm_step_and_velocity(clip, spacing):
    jc, tc = _cfgs(clip_sample=clip, timestep_spacing=spacing)
    jsch, tsch = js.DDPMScheduler(jc), ts.DDPMScheduler(tc)
    jstate, tstate = jsch.set_timesteps(4), tsch.set_timesteps(4)
    np.testing.assert_array_equal(tstate.timesteps.numpy(),
                                  np.asarray(jstate.timesteps))
    x, eps = _rand(4), _rand(5)
    for i in range(4):
        key = jax.random.PRNGKey(30 + i)
        want = jsch.step(jstate, jnp.asarray(eps), i, jnp.asarray(x), key=key)
        got = tsch.step(tstate, torch.from_numpy(eps), i, torch.from_numpy(x),
                        noise=torch.from_numpy(_jax_noise(key)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want = jsch.step(jstate, jnp.asarray(eps), i, jnp.asarray(x))
        got = tsch.step(tstate, torch.from_numpy(eps), i, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    t = np.array([17, 999])
    want = jsch.get_velocity(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    got = tsch.get_velocity(torch.from_numpy(x), torch.from_numpy(eps),
                            torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddpm_step_at_t0_adds_no_noise():
    tsch = ts.DDPMScheduler(tcfg.SchedulerConfig(timestep_spacing="linspace"))
    state = tsch.set_timesteps(3)
    assert int(state.timesteps[-1]) == 0
    x, eps = torch.from_numpy(_rand(6)), torch.from_numpy(_rand(7))
    assert torch.equal(tsch.step(state, eps, 2, x, noise=torch.ones(SHAPE)),
                       tsch.step(state, eps, 2, x))


def test_karras_restore_matches_jax():
    """The tiny 2-tile restore of `test_torch_pipeline.py` with Karras
    sigmas on both sides, at that test's tolerance."""
    unet, vae, de = tiny_restore_params()
    jc, tc = _cfgs(use_karras_sigmas=True)
    jpipe = jax_build_tiny_pipeline(
        pipeline_config=JaxPipelineConfig(tile_size=64, num_inference_steps=3),
        scheduler_config=jc, unet_params=unet, vae_params=vae,
        denoise_encoder_params=de)
    tpipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=3),
        scheduler_config=tc, unet_state_dict=state_dict_from_flax(unet),
        vae_state_dict=state_dict_from_flax(vae),
        denoise_encoder_state_dict=state_dict_from_flax(de), device="cpu")
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    pe = rng.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 64)).astype(np.float32)
    want = jpipe(img, jnp.asarray(pe), jnp.asarray(pooled), seed=3,
                 output_type="latent", noise_source="torch",
                 start_point="noise")
    got = tpipe(img, pe, pooled, seed=3, output_type="latent",
                start_point="noise")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
