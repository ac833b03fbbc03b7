"""Captioner training in the port (`training/caption_train.py`, `lora.py`)
against the JAX package's optax at fp32 on the CPU, at the tiny LLaMA and
vision tower: three steps of loss, `grad_norm` and every tensor in each
trainable mode ("projector", "lm", "full"), a step where the clip engages
in "projector" mode (its scale set by the frozen LLaMA's gradient), and a
LoRA step; frozen tensors bitwise still; the LoRA init, the PEFT
interchange and the merged forward against JAX's.

Tolerances: the losses and norms within 1e-5 relative; the tensors
within 1e-5 + 1e-4 relative. fp32 on both sides; the sums of the
forward, of the backward and of the global norm round in another order,
and Adam divides by the square root of the second moment, which carries
those differences into the update."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faithdiff_tpu.captioner import clip_vision as jc
from faithdiff_tpu.captioner import llama as jl
from faithdiff_tpu.training import caption_train as jct
from faithdiff_tpu.training import lora as jlora
from faithdiff_tpu_torch.captioner import clip_vision as tc
from faithdiff_tpu_torch.captioner import llama as tl
from faithdiff_tpu_torch.training import caption_train as tct
from faithdiff_tpu_torch.training import lora as tlora
from faithdiff_tpu_torch.utils.convert import (clip_vision_state_dict_from_flax,
                                               llama_state_dict_from_flax,
                                               projector_state_dict_from_flax)
from port_parity import random_params

POS = 2
STEPS = 3
LR = 1e-3
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    vcfg, lcfg = jc.tiny_vision_config(), jl.LlamaConfig.tiny()
    vision, projector = jc.CLIPVisionTower(vcfg), jc.VisionProjector(lcfg.hidden_size)
    llama = jl.LlamaForCausalLM(lcfg)
    pix = jnp.zeros((2, vcfg.image_size, vcfg.image_size, 3))
    vp = _f32(random_params(vision, 0, pix)["params"])
    n_img = vision.apply({"params": vp}, pix).shape[1]
    pp = _f32(random_params(projector, 1, jnp.zeros((1, n_img, vcfg.hidden_size)))
              ["params"])
    ids0 = jnp.zeros((1, 4), jnp.int32)
    lp = _f32(random_params(llama, 2, ids0, ids0,
                            method=jl.LlamaForCausalLM.init_forward,
                            norm_leaves=("weight",))["params"])
    rng = np.random.default_rng(0)
    s = POS + n_img + 8
    ids = rng.integers(3, 200, (2, s)).astype(np.int32)
    labels = np.full((2, s), jct.IGNORE_INDEX, np.int32)
    labels[:, -6:] = rng.integers(3, 200, (2, 6))
    pixels = rng.standard_normal((2, vcfg.image_size, vcfg.image_size, 3)
                                 ).astype(np.float32)
    return dict(vcfg=vcfg, lcfg=lcfg, vision=vision, projector=projector,
                llama=llama, params={"llama": lp, "vision": vp, "projector": pp},
                n_img=n_img, batch={"input_ids": ids, "labels": labels,
                                    "pixels": pixels})


def _port_modules(st):
    llama = tl.LlamaForCausalLM(tl.LlamaConfig(**dataclasses.asdict(st["lcfg"])))
    llama.load_state_dict(llama_state_dict_from_flax({"params": st["params"]["llama"]}))
    vision = tc.CLIPVisionTower(tc.CLIPVisionConfig(**dataclasses.asdict(st["vcfg"])))
    vision.load_state_dict(clip_vision_state_dict_from_flax(
        {"params": st["params"]["vision"]}))
    projector = tc.VisionProjector(st["lcfg"].hidden_size, st["vcfg"].hidden_size)
    projector.load_state_dict(projector_state_dict_from_flax(
        {"params": st["params"]["projector"]}))
    return {"llama": llama, "vision": vision, "projector": projector}


def _carry(group, tree):
    fn = {"llama": llama_state_dict_from_flax,
          "vision": clip_vision_state_dict_from_flax,
          "projector": projector_state_dict_from_flax}[group]
    return fn({"params": _f32(tree)})


def _hf(key):
    """A key of JAX's `lora_torch_state_dict` -> transformers' (and PEFT's)
    name: the JAX LLaMA holds its MLP projections on the layer, so its
    export drops the `mlp.` level that LLaVA's LoRA files carry."""
    for name in (".gate_proj.", ".up_proj.", ".down_proj."):
        key = key.replace(name, ".mlp" + name)
    return key


def _from_jax(exported):
    return {_hf(k): torch.from_numpy(np.ascontiguousarray(v))
            for k, v in exported.items()}


def _torch_batch(batch):
    return {"input_ids": torch.from_numpy(batch["input_ids"]).long(),
            "labels": torch.from_numpy(batch["labels"]).long(),
            "pixels": torch.from_numpy(batch["pixels"])}


def _jax_step(st, tx):
    return jax.jit(jct.make_caption_train_step(
        llama_apply=lambda p, e, pos: st["llama"].apply(p, e, pos),
        embed_apply=lambda p, ids: st["llama"].apply(
            p, ids, method=jl.LlamaForCausalLM.embed),
        vision_apply=lambda p, x: st["vision"].apply(p, x),
        projector_apply=lambda p, f: st["projector"].apply(p, f),
        tx=tx, image_token_pos=POS, num_image_tokens=st["n_img"]))


@pytest.mark.parametrize("trainable,max_norm", [
    ("projector", 1.0), ("lm", 1.0), ("full", 1.0), ("projector", 1e-3)],
    ids=["projector", "lm", "full", "projector-clipped"])
def test_caption_train_steps_match_optax(setup, trainable, max_norm):
    st = setup
    kw = dict(trainable=trainable, learning_rate=LR, projector_lr=2 * LR,
              weight_decay=0.01, max_grad_norm=max_norm)
    tx = jct.make_caption_optimizer(st["params"], **kw)
    jstep = _jax_step(st, tx)
    jstate = jct.CaptionTrainState(jnp.zeros((), jnp.int32), st["params"],
                                   tx.init(st["params"]))
    modules = _port_modules(st)
    before = {g: {k: v.detach().clone() for k, v in m.state_dict().items()}
              for g, m in modules.items()}
    state = tct.CaptionTrainState(0, modules,
                                  tct.make_caption_optimizer(modules, **kw))
    step = tct.make_caption_train_step(POS)
    batch = {k: jnp.asarray(v) for k, v in st["batch"].items()}
    tbatch = _torch_batch(st["batch"])
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, batch)
        m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        if max_norm < 1:
            assert float(jm["grad_norm"]) > 10 * max_norm   # the clip engages
    frozen = {"projector": ("llama", "vision"), "lm": ("vision",),
              "full": ()}[trainable]
    for g, mod in modules.items():
        want = _carry(g, jstate.params[g])
        for k, v in mod.state_dict().items():
            if g in frozen:
                assert torch.equal(v, before[g][k]), (g, k)
            else:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           err_msg=f"{g}.{k}", **TOL)
    moved = [k for k, v in modules["projector"].state_dict().items()
             if not torch.equal(v, before["projector"][k])]
    assert len(moved) == len(before["projector"])


def test_lora_targets_and_interchange_match_jax(setup):
    st = setup
    base = st["params"]["llama"]
    jl_ = jlora.init_lora(base, rank=4, rng=jax.random.PRNGKey(3), alpha=8.0)
    jl_ = jax.tree.map(lambda x: x + 0.05, jl_)    # B nonzero
    llama = _port_modules(st)["llama"]
    ours = tlora.init_lora(llama, rank=4, generator=torch.Generator().manual_seed(0),
                           alpha=8.0)
    exported = {_hf(k): v for k, v in jlora.lora_torch_state_dict(
        jl_, prefix="base_model.model.").items()}
    assert tlora.count_lora_modules(ours) == jlora.count_lora_modules(jl_) == 14
    assert ({"base_model.model." + k: tuple(v.shape) for k, v in ours.items()
             if k != "_alpha"} == {k: v.shape for k, v in exported.items()})
    assert float(ours["_alpha"]) == 8.0
    # JAX's adapter carried over, then back out: the same PEFT dict
    carried = tlora.load_peft_lora(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()},
        alpha=float(jl_["_alpha"]))
    back = tlora.lora_torch_state_dict(carried, prefix="base_model.model.")
    assert set(back) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v))
    jback = jlora.load_peft_lora(jlora.lora_torch_state_dict(jl_))
    assert jlora.count_lora_modules(jback) == tlora.count_lora_modules(carried)
    # merged state dicts, and the forward with the adapter applied, against
    # JAX's merged weights
    merged = jlora.merge_lora(base, jl_)
    want_sd = llama_state_dict_from_flax({"params": _f32(merged)})
    got_sd = tlora.merge_lora(llama.state_dict(), carried)
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    emb = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).copy()
    want, _ = st["llama"].apply({"params": merged}, jnp.asarray(emb),
                                jnp.asarray(pos))
    with torch.no_grad(), tlora.lora_applied(llama, carried):
        got, _ = llama(torch.from_numpy(emb), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_lora_train_steps_match_optax(setup):
    """JAX merges w + s A@B inside the loss; the port adds s (x A) B at each
    adapted module: the same function, held over three steps. JAX's step
    differentiates the whole adapter tree, `_alpha` included, and so does
    the port's."""
    st = setup
    base = st["params"]["llama"]
    jl_ = jlora.init_lora(base, rank=4, rng=jax.random.PRNGKey(4), alpha=8.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=0.0))

    def loss_from_params(p, batch):
        params = {"llama": p, "vision": st["params"]["vision"],
                  "projector": st["params"]["projector"]}
        ids = batch["input_ids"]
        b, s = ids.shape
        emb = st["llama"].apply({"params": p}, ids, method=jl.LlamaForCausalLM.embed)
        feats = jax.lax.stop_gradient(st["vision"].apply(
            {"params": params["vision"]}, batch["pixels"]))
        img = st["projector"].apply({"params": params["projector"]}, feats)
        emb = jax.lax.dynamic_update_slice(emb, img.astype(emb.dtype), (0, POS, 0))
        positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        logits, _ = st["llama"].apply({"params": p}, emb, positions)
        labels = batch["labels"][:, 1:]
        mask = labels != jct.IGNORE_INDEX
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, jnp.where(mask, labels, 0)[..., None],
                                   -1)[..., 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1)

    jstep = jax.jit(jlora.make_lora_train_step(loss_from_params, base, tx))
    jopt = tx.init(jl_)
    modules = _port_modules(st)
    carried = tlora.load_peft_lora(_from_jax(jlora.lora_torch_state_dict(jl_)),
                                   alpha=8.0)
    opt = tct.CaptionOptimizer(carried, {k: "train" for k in carried},
                               learning_rate=LR)
    before = {k: v.detach().clone() for k, v in modules["llama"].state_dict().items()}
    step = tlora.make_lora_train_step(
        lambda model, b: tct.caption_loss(model, modules["vision"],
                                          modules["projector"], b, POS),
        modules["llama"], opt.update_)
    batch = {k: jnp.asarray(v) for k, v in st["batch"].items()}
    tbatch = _torch_batch(st["batch"])
    for _ in range(STEPS):
        jl_, jopt, jm = jstep(jl_, jopt, batch)
        m = step(carried, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
    want = {_hf(k): v for k, v in jlora.lora_torch_state_dict(jl_).items()}
    want["_alpha"] = jl_["_alpha"]       # JAX's step trains alpha too
    assert float(jl_["_alpha"]) != 8.0
    for k, v in want.items():
        np.testing.assert_allclose(carried[k].numpy(), np.asarray(v),
                                   err_msg=k, **TOL)
        assert not torch.equal(carried[k], torch.zeros_like(carried[k]))
    for k, v in modules["llama"].state_dict().items():
        assert torch.equal(v, before[k]), k
