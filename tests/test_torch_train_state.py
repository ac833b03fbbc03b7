"""The port's optimizer, EMA, checkpoints and resume
(`faithdiff_tpu_torch/training/train.py`, `ema.py`, `checkpoint.py`)
against optax, the JAX EMA and orbax, on the CPU.

- The optimizer: the same seeded gradient sequence goes to the JAX
  package's `make_optimizer` (clip, AdamW per train / vis group, optax
  `MultiSteps`) and to the port's `Optimizer` for 8 calls; parameters
  within 1e-6 * (1 + |p|) after every call, the LR within 1e-7 of optax's
  schedule at every count, parameters bitwise still between accumulation
  boundaries; with the global norm above and below `max_grad_norm`.
- EMA: 12 micro-steps at interval 3 x grad_accum 2, within 1e-7.
- Resume: N micro-steps straight against N/2, a save, a restore into a
  fresh state and N/2 more, bitwise equal in every tensor and count.
- The save rule: the steps the port's manager keeps equal those orbax's
  `CheckpointManager` keeps, for the same interval, `max_to_keep`, run
  length and final forced save (which both refuse at an existing step).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
import torch.nn as nn

from faithdiff_tpu.config import TrainConfig as JaxTrainConfig
from faithdiff_tpu.training import ema as jax_ema
from faithdiff_tpu.training import train as jax_train
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.models.vae import AutoencoderKL, DenoiseEncoder
from faithdiff_tpu_torch.pipelines.factory import random_init_
from faithdiff_tpu_torch.training import ema as port_ema
from faithdiff_tpu_torch.training.checkpoint import (CheckpointManager,
                                                     StepAlreadyExistsError)
from faithdiff_tpu_torch.training.train import (Optimizer, init_train_state,
                                                make_train_step)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# a parameter tree with both groups: stage 2 labels the UNet "train" and
# the denoise encoder "vis"
SHAPES = {"unet": {"conv_in": {"kernel": (3, 3, 2, 4), "bias": (4,)},
                   "proj": {"kernel": (5, 3)}},
          "denoise_encoder": {"conv": {"kernel": (2, 6), "bias": (6,)}}}


def _tree(rng, scale=1.0):
    return jax.tree.map(lambda s: (scale * rng.standard_normal(s)).astype(
        np.float32), SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _flat(tree):
    return {f"{m}." + "/".join(str(getattr(k, "key", k)) for k in path): leaf
            for m in tree for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree[m])[0]}


@pytest.mark.parametrize("accum,scheduler,grad_scale", [
    (1, "cosine", 0.01), (3, "cosine", 10.0), (1, "constant", 10.0),
    (3, "constant", 0.01)])
def test_optimizer_matches_optax(accum, scheduler, grad_scale):
    kw = dict(stage=2, grad_accum=accum, lr_scheduler=scheduler,
              lr_warmup_steps=2, max_train_steps=8, learning_rate=1e-2,
              vis_learning_rate=3e-3, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(8)]
    tx = jax_train.make_optimizer(JaxTrainConfig(**kw), params)
    state = tx.init(params)

    @jax.jit
    def update(g, s, p):
        """One compiled update, not a dispatch per optax primitive."""
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    flat = _flat(params)
    port_params = {k: nn.Parameter(torch.tensor(v)) for k, v in flat.items()}
    labels = {k: "vis" if k.startswith("denoise_encoder.") else "train"
              for k in flat}
    opt = Optimizer(tcfg.TrainConfig(**kw), port_params, labels)
    jax_sched = jax_train.make_lr_schedule(JaxTrainConfig(**kw))
    vis_sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 8, 0.0)
    for count in range(10):
        assert abs(opt.lr("train", count) - float(jax_sched(count))) <= 1e-7
        assert abs(opt.lr("vis", count) - float(vis_sched(count))) <= 1e-7

    clipped = 0
    for i, g in enumerate(grads):
        params, state = update(g, state, params)
        before = {k: p.detach().clone() for k, p in port_params.items()}
        gflat = _flat(g)
        with opt.accumulating():
            loss = sum((p * torch.tensor(gflat[k])).sum()
                       for k, p in port_params.items())
            loss.backward()
        clipped += math.sqrt(sum(float((v ** 2).sum())
                                 for v in gflat.values())) >= 1.0
        emitted = opt.step()
        assert emitted == ((i + 1) % accum == 0)
        for k, ref in _flat(params).items():
            p = port_params[k].detach().numpy()
            assert np.all(np.abs(p - ref) <= 1e-6 * (1 + np.abs(ref))), (i, k)
            if not emitted:
                assert torch.equal(port_params[k].detach(), before[k])
    assert clipped == (8 if grad_scale > 1 else 0)


def test_ema_matches_jax():
    rng = np.random.default_rng(1)
    seq = [{"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
           for _ in range(13)]
    js = jax_ema.ema_init(seq[0])
    ps = port_ema.ema_init({k: torch.tensor(v) for k, v in seq[0].items()})
    for step in range(1, 13):
        new = seq[step]
        js = jax_ema.ema_update(js, new, jnp.asarray(step), interval=3 * 2,
                                decay=0.9999)
        port_ema.ema_update(ps, {k: torch.tensor(v) for k, v in new.items()},
                            step, interval=3 * 2, decay=0.9999)
        assert ps.step == int(js.step)
        for k in new:
            assert np.abs(ps.params[k].numpy() - np.asarray(js.params[k])
                          ).max() <= 1e-7
    assert ps.step == 2
    for s in range(6):
        assert port_ema.ema_decay_for_step(s) == pytest.approx(
            float(jax_ema.ema_decay_for_step(jnp.asarray(s))), abs=1e-7)


def _tiny_state(seed):
    """A stage-2 state whose UNet and denoise encoder come from `seed`; the
    VAE, which no checkpoint holds, is the same every time (a resumed run
    loads it from the same files or seed)."""
    unet = UNet2DConditionModel(tcfg.tiny_unet_config())
    de = DenoiseEncoder(tcfg.tiny_denoise_encoder_config())
    vae = AutoencoderKL(tcfg.tiny_vae_config())
    gen = torch.Generator().manual_seed(seed)
    for m in (unet, de):
        random_init_(m, gen)
    random_init_(vae, torch.Generator().manual_seed(0))
    vae.requires_grad_(False)
    cfg = tcfg.TrainConfig(stage=2, grad_accum=3, lr_warmup_steps=0,
                           ema_update_interval=1, learning_rate=1e-3)
    state = init_train_state(cfg, unet, de)
    return state, make_train_step(unet, de, vae, cfg,
                                  compute_dtype=torch.float32)


def _batches(n):
    r = np.random.default_rng(4)
    return [{"hr": r.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32),
             "lq": r.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32),
             "prompt_embeds": r.standard_normal((1, 77, 64)).astype(np.float32),
             "pooled_embeds": r.standard_normal((1, 64)).astype(np.float32),
             "add_time_ids": np.zeros((1, 6), np.float32)} for _ in range(n)]


def _snapshot(state):
    out = {"count": (state.step, state.opt.mini_step, state.opt.gradient_step,
                     state.ema.step)}
    for name, p in state.trainable().items():
        out[f"p.{name}"] = p.detach().clone()
        out[f"mu.{name}"] = state.opt.mu[name].clone()
        out[f"nu.{name}"] = state.opt.nu[name].clone()
        out[f"ema.{name}"] = state.ema.params[name].clone()
        out[f"acc.{name}"] = None if p.grad is None else p.grad.clone()
    return out


def test_resume_is_bitwise_equal_to_a_straight_run(tmp_path):
    batches = _batches(4)
    state, step = _tiny_state(0)
    gen = torch.Generator().manual_seed(11)
    for b in batches:
        step(state, b, gen)
    straight = _snapshot(state)

    state, step = _tiny_state(0)
    gen = torch.Generator().manual_seed(11)
    for b in batches[:2]:
        step(state, b, gen)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=1)
    assert mgr.save(2, state, generator=gen)
    del state, step, gen
    fresh, step = _tiny_state(5)           # other weights: all must load
    CheckpointManager(str(tmp_path)).restore(fresh)
    # the saved generator state, which the runner keeps and (restarting
    # from --seed, as JAX does) never reads back
    gen = torch.Generator()
    gen.set_state(torch.load(tmp_path / "2" / "train_state.pt",
                             weights_only=True)["generator"])
    assert fresh.step == 2 and fresh.opt.mini_step == 2
    for b in batches[2:]:
        step(fresh, b, gen)
    resumed = _snapshot(fresh)
    assert straight["count"] == resumed["count"] == (4, 1, 1, 1)
    for k, v in straight.items():
        if k == "count":
            continue
        if v is None:
            assert resumed[k] is None, k
        else:
            assert torch.equal(v, resumed[k]), k


def _port_saver(tmp_path, interval, keep):
    state = init_train_state(tcfg.TrainConfig(stage=2), nn.Linear(2, 2),
                             nn.Linear(2, 2))
    return CheckpointManager(str(tmp_path / "port"), max_to_keep=keep,
                             save_interval_steps=interval), state


@pytest.mark.parametrize("interval,keep,length", [(2, 2, 7), (3, 5, 10),
                                                  (1, 1, 4), (4, 2, 8)])
def test_save_rule_matches_orbax(tmp_path, interval, keep, length):
    jmgr = ocp.CheckpointManager(
        str(tmp_path / "jax"), options=ocp.CheckpointManagerOptions(
            max_to_keep=keep, save_interval_steps=interval, create=True))
    pmgr, state = _port_saver(tmp_path, interval, keep)
    item = {"a": np.zeros(2, np.float32)}
    for step in range(1, length + 1):
        saved_j = jmgr.save(step, args=ocp.args.StandardSave(item))
        assert pmgr.save(step, state) == bool(saved_j), step
    # the JAX runner's final forced save; at a step that exists both refuse
    try:
        jmgr.save(length, args=ocp.args.StandardSave(item), force=True)
        jax_raised = False
    except Exception as e:
        jax_raised = "already exists" in str(e)
    try:
        pmgr.save(length, state, force=True)
        port_raised = False
    except StepAlreadyExistsError:
        port_raised = True
    assert port_raised == jax_raised
    jmgr.wait_until_finished()
    assert pmgr.all_steps() == list(jmgr.all_steps())
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == \
        sorted(jmgr.all_steps())
    jmgr.close()
