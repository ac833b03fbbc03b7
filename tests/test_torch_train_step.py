"""The port's FaithDiff train step (`faithdiff_tpu_torch/training/train.py`)
against the JAX package's `make_train_step` on the tiny configs, built as
`tests/test_training.py::_setup` builds it, with numpy-made weights
carried by `state_dict_from_flax`, the same batch and JAX's own draws
(posterior noise, noise, offset noise, timesteps), fp32 on the CPU. With
`grad_accum=2` the port's first micro-step leaves its gradient in `.grad`;
JAX's step is given a transformation that keeps the gradient it is
handed as its state (and updates nothing), so the step traces without
the optimizer. They are compared: every trainable leaf within
1e-4 * max|g_leaf| + 1e-7; loss and grad_norm within 1e-5 relative; the
set of parameters that take gradients equal to the key-map image of
JAX's train / vis labels. Both sides run the tiny configs with one
ResNet a block and one transformer layer a level (`_step_configs`): the
same topology, about half the graph for XLA to compile, which it does at
its lowest backend optimisation level (the step's cost here is that
compile). Gradient checkpointing is held against the port's own step
without it (1e-6 * max|g_leaf|)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faithdiff_tpu import config as jcfg
from faithdiff_tpu.models.unet import UNet2DConditionModel as JaxUNet
from faithdiff_tpu.models.vae import AutoencoderKL as JaxVAE
from faithdiff_tpu.models.vae import DenoiseEncoder as JaxDenoiseEncoder
from faithdiff_tpu.models.vae import sample_from_moments as jax_sample
from faithdiff_tpu.training import train as jax_train
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.models.vae import AutoencoderKL, DenoiseEncoder
from faithdiff_tpu_torch.training.train import (init_train_state,
                                                make_train_step, named_params)
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import random_params

RES, BATCH = 32, 2
# XLA's CPU backend at its cheapest: the step compiles in about two thirds
# of the time, and fp32 results stay within the comparisons' tolerances
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(stage):
    return dict(stage=stage, max_train_steps=50, lr_warmup_steps=0,
                learning_rate=1e-3, vis_learning_rate=1e-4, noise_offset=0.02,
                ema_update_interval=1, grad_accum=2)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return {
        "hr": r.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32),
        "lq": r.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32),
        "prompt_embeds": r.standard_normal((BATCH, 77, 64)).astype(np.float32),
        "pooled_embeds": r.standard_normal((BATCH, 64)).astype(np.float32),
        "add_time_ids": r.uniform(0, 64, (BATCH, 6)).astype(np.float32),
    }


def _jax_draws(key):
    """The randomness JAX's step draws from `key`, in the port's layout."""
    k_vae, k_noise, k_off, k_t = jax.random.split(key, 4)
    lat = (BATCH, RES // 8, RES // 8, 4)

    def nchw(a):
        return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())

    return {
        "posterior": nchw(jax.random.normal(k_vae, lat, jnp.float32)),
        "noise": nchw(jax.random.normal(k_noise, lat, jnp.float32)),
        "offset": nchw(jax.random.normal(k_off, (BATCH, 1, 1, 4), jnp.float32)),
        "t": torch.from_numpy(np.asarray(
            jax.random.randint(k_t, (BATCH,), 0, 1000)).astype(np.int64)),
    }


def _drop_none(tree):
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def _port_grads_of(jax_tree):
    """JAX (partial) param tree {"unet", "denoise_encoder"} -> port names."""
    out = {}
    tree = _drop_none(jax.device_get(jax_tree))
    for model in ("unet", "denoise_encoder"):
        if tree.get(model):
            out.update({f"{model}.{k}": v
                        for k, v in state_dict_from_flax(tree[model]).items()})
    return out


def _step_configs(mod):
    """`mod`'s (the JAX or the port's config module) tiny UNet, denoise
    encoder and VAE configs with one ResNet a block and one transformer
    layer at every level and in the fusion stack."""
    return (dataclasses.replace(mod.tiny_unet_config(), layers_per_block=1,
                                transformer_layers_per_block=(1, 1, 1),
                                info_transformer_layers=1),
            dataclasses.replace(mod.tiny_denoise_encoder_config(),
                                layers_per_block=1),
            dataclasses.replace(mod.tiny_vae_config(), layers_per_block=1))


@pytest.fixture(scope="module")
def step_params():
    """Flax params of the `_step_configs` models, made with numpy (seeds 0,
    1, 2), in `port_parity.tiny_restore_params`' order."""
    ucfg, dcfg, vcfg = _step_configs(jcfg)
    z = jnp.zeros
    unet = random_params(JaxUNet(config=ucfg), 0, z((2, 8, 8, 4)), z((2,)),
                         z((2, 77, 64)), z((2, 64)), z((2, 6)),
                         z((2, 8, 8, 64)))
    vae = random_params(JaxVAE(config=vcfg), 1, z((1, 64, 64, 3)))
    de = random_params(JaxDenoiseEncoder(config=dcfg), 2, z((1, 64, 64, 3)))
    return unet, vae, de


def _jax_step(params, stage):
    unet_p, vae_p, de_p = params
    ucfg, dcfg, vcfg = _step_configs(jcfg)
    unet = JaxUNet(config=ucfg)
    de = JaxDenoiseEncoder(config=dcfg)
    vae = JaxVAE(config=vcfg)
    cfg = jcfg.TrainConfig(**_cfg(stage))
    state, _ = jax_train.init_train_state(cfg, unet_p, de_p)
    labels = jax_train.param_labels(state.params, stage)
    train, _ = jax_train.partition_params(state.params, labels)
    # keeps the gradient as its state: what the step differentiates, without
    # tracing the optimizer chain
    tx = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    state = state._replace(opt_state=tx.init(train))
    sf = vcfg.scaling_factor

    def vae_encode(p, img, key):
        m = vae.apply(p, img, method=JaxVAE.encode_moments)
        return jax_sample(m, key).astype(jnp.float32) * sf

    def unet_apply(p, *args):
        return unet.apply(p, *args[:6], add_sample=args[6],
                          fusion_group_size=args[7])

    step = jax_train.make_train_step(
        unet_apply, lambda p, x: de.apply(p, x), vae_encode, vae_p, tx, cfg,
        jcfg.SchedulerConfig())
    key = jax.random.PRNGKey(7)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    compiled = jax.jit(step).lower(state, batch, key).compile(
        compiler_options=FAST_COMPILE)
    new_state, metrics = compiled(state, batch, key)
    return (new_state.opt_state, metrics, set(_port_grads_of(train)),
            _jax_draws(key))


def _port_step(params, stage, configs, remat=False, draws=None):
    unet_p, vae_p, de_p = params
    ucfg, dcfg, vcfg = configs
    unet = UNet2DConditionModel(dataclasses.replace(ucfg, remat=remat))
    de = DenoiseEncoder(dataclasses.replace(dcfg, remat=remat))
    vae = AutoencoderKL(vcfg)
    for model, p in ((unet, unet_p), (de, de_p), (vae, vae_p)):
        model.load_state_dict(state_dict_from_flax(p), strict=True)
    vae.requires_grad_(False)
    cfg = tcfg.TrainConfig(**_cfg(stage))
    state = init_train_state(cfg, unet, de)
    step = make_train_step(unet, de, vae, cfg, tcfg.SchedulerConfig(),
                           compute_dtype=torch.float32)
    metrics = step(state, _batch(), draws=draws)
    grads = {k: p.grad.clone() for k, p in named_params(unet, de).items()
             if p.grad is not None}
    trainable = {k for k, p in named_params(unet, de).items() if p.requires_grad}
    return state, metrics, grads, trainable


@pytest.fixture(scope="module", params=[1, 2])
def stage_run(request, step_params):
    stage = request.param
    jax_grads, jax_metrics, jax_trainable, draws = _jax_step(step_params,
                                                             stage)
    port = _port_step(step_params, stage, _step_configs(tcfg), draws=draws)
    return stage, jax_grads, jax_metrics, jax_trainable, draws, port


def test_loss_and_grad_norm_match_jax(stage_run):
    _, _, jax_metrics, _, _, (_, metrics, _, _) = stage_run
    for name in ("loss", "grad_norm"):
        ref = float(jax_metrics[name])
        assert abs(float(metrics[name]) - ref) <= 1e-5 * abs(ref), name


def test_every_trainable_gradient_matches_jax(stage_run):
    _, jax_grads, _, _, _, (_, _, grads, _) = stage_run
    ref = _port_grads_of(jax_grads)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name]
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item() + 1e-7, (name, err)


def test_trainable_set_is_the_image_of_jax_labels(stage_run):
    stage, _, _, jax_trainable, _, (_, _, _, trainable) = stage_run
    assert trainable == jax_trainable
    if stage == 1:
        assert "unet.spatial_ch_projs.weight" in trainable
        assert "unet.information_transformer_layes.0.attn.in_proj_weight" \
            in trainable
        assert not any(k.startswith("denoise_encoder.") for k in trainable)
        assert "unet.conv_in.weight" not in trainable


@pytest.mark.parametrize("stage", [1, 2])
def test_remat_changes_no_gradient(step_params, stage):
    draws = _jax_draws(jax.random.PRNGKey(3))
    configs = _step_configs(tcfg)
    _, m0, g0, _ = _port_step(step_params, stage, configs, remat=False,
                              draws=draws)
    _, m1, g1, _ = _port_step(step_params, stage, configs, remat=True,
                              draws=draws)
    assert float(m0["loss"]) == float(m1["loss"])
    assert set(g0) == set(g1)
    for name, g in g0.items():
        err = (g1[name] - g).abs().max().item()
        assert err <= 1e-6 * g.abs().max().item(), (name, err)
