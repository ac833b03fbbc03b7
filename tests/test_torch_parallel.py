"""Multi-GPU, held on the CPU (`faithdiff_tpu_torch/parallel/`): two gloo
processes (`tests/torch_dist_workers.rank_main`, spawned once for the
module, each joined with a timeout of its own so that a hang fails the
test) against one process, and the sharding plans against the JAX
package's on the 8-device CPU mesh of `tests/conftest.py`.

- the tile-parallel tiny restore at 3 tiles (padded to 4 over 2 ranks),
  in one chunk and in chunks of 2, within 1e-5 * (1 + max|ref|) of the
  one-process restore;
- two data-parallel optimizer steps at stage 1 and at stage 2: params
  and EMA (the checkpoint rank 0 wrote) within 1e-5 * max|ref| of one
  process, tensor by tensor, the gathered AdamW moments within 1e-5 of
  the largest moment of their kind; each rank keeping half the rows of every
  even-rowed moment (and at stage 2 of the EMA); the one-process
  checkpoint resumed on two ranks equal in every bit;
- `shard_leading_divisible` and the tensor-parallel plan, tensor by
  tensor, as JAX's `shard_leading_divisible` / `unet_tp_shardings` place
  the same tensors; the TP tiny-UNet forward within 2e-5 of the
  replicated one (`tests/test_tp.py`'s tolerance).
"""
import multiprocessing
import os
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import torch_dist_workers as W
from faithdiff_tpu.config import tiny_unet_config as jax_tiny_unet_config
from faithdiff_tpu.models.unet import UNet2DConditionModel as FlaxUNet
from faithdiff_tpu.parallel.mesh import make_mesh as jax_make_mesh
from faithdiff_tpu.parallel.mesh import \
    shard_leading_divisible as jax_shard_leading_divisible
from faithdiff_tpu.parallel.tp import unet_tp_shardings
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.parallel import distributed
from faithdiff_tpu_torch.parallel.mesh import shard_leading_divisible
from faithdiff_tpu_torch.parallel.tp import unet_tp_plan
from faithdiff_tpu_torch.training.checkpoint import CheckpointManager, state_to_dict
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax

WORLD = 2
JOIN_S = 300


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process runs: the restores, and both stages' two steps with
    a checkpoint each."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("one")
    out = {f"restore_{c}": W.restore(W.restore_pipe(c)) for c in W.CHUNKS}
    for stage in (1, 2):
        state, step = W.train_state(stage, data_parallel=False)
        W.train(state, step)
        out[f"state{stage}"] = state_to_dict(state)
        out[f"ckpt{stage}"] = str(root / f"stage{stage}")
        CheckpointManager(out[f"ckpt{stage}"], save_interval_steps=1).save(
            W.TRAIN_STEPS, state)
    with torch.no_grad():
        out["tp"] = W.tp_unet()(*W.tp_inputs())
    return out


@pytest.fixture(scope="module")
def ranks(one_process, tmp_path_factory):
    """`rank_main` on WORLD spawned gloo ranks; their results by rank."""
    root = tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    ckpts = {s: one_process[f"ckpt{s}"] for s in (1, 2)}
    procs = [ctx.Process(target=W.rank_main, args=(r, WORLD, port, str(root), ckpts))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return dict(root=root, out=[torch.load(root / f"rank{r}.pt", weights_only=False)
                                for r in range(WORLD)])


def _close(got, want, rtol, plus_one=False, what=""):
    scale = float(want.abs().max()) + (1.0 if plus_one else 0.0)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (what, err, scale)


def test_local_batch_slice():
    assert distributed.local_batch_slice(16) == slice(0, 16)     # no group
    assert distributed.init_distributed() == 0                   # a no-op


def test_ranks_take_their_batch_rows(ranks):
    assert [o["slice"] for o in ranks["out"]] == [slice(0, 2), slice(2, 4)]


@pytest.mark.parametrize("chunk", W.CHUNKS)
def test_tile_parallel_restore_matches_one_process(ranks, one_process, chunk):
    want = one_process[f"restore_{chunk}"]
    for out in ranks["out"]:
        got = out[f"restore_{chunk}"]
        assert got.shape == want.shape == (1, 8, 16, 4)
        _close(got, want, 1e-5, plus_one=True)
    assert torch.equal(ranks["out"][0][f"restore_{chunk}"],
                       ranks["out"][1][f"restore_{chunk}"])


@pytest.mark.parametrize("stage", [1, 2])
def test_data_parallel_steps_match_one_process(ranks, one_process, stage):
    """The checkpoint the two ranks wrote (rank 0, gathered) against the
    one-process state: params, both moments, the EMA."""
    want = one_process[f"state{stage}"]
    got = torch.load(os.path.join(ranks["root"], f"stage{stage}", str(W.TRAIN_STEPS),
                                  "train_state.pt"), weights_only=True)
    assert (got["step"], got["opt"]["gradient_step"], got["ema"]["step"]) == (
        want["step"], want["opt"]["gradient_step"], want["ema"]["step"]) == (2, 2, 2)
    for model in ("unet", "denoise_encoder"):
        for k, v in want["params"][model].items():
            _close(got["params"][model][k], v, 1e-5, what=k)
    # the moments against the largest of their kind: a key bias's gradient
    # is rounding noise (softmax is blind to it), whose own scale is no
    # yardstick
    for part in ("mu", "nu"):
        assert sorted(got["opt"][part]) == sorted(want["opt"][part])
        top = max(float(v.abs().max()) for v in want["opt"][part].values())
        for k, v in want["opt"][part].items():
            err = float((got["opt"][part][k] - v).abs().max())
            assert err <= 1e-5 * top, (part, k, err, top)
    for k, v in want["ema"]["params"].items():
        _close(got["ema"]["params"][k], v, 1e-5, what=("ema", k))


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_keeps_a_share_and_resumes_on_any_world(ranks, one_process, stage):
    want = one_process[f"state{stage}"]
    for out in ranks["out"]:
        for k, v in want["opt"]["mu"].items():
            share = tuple(v.shape)
            if v.ndim and v.shape[0] % WORLD == 0:
                share = (v.shape[0] // WORLD,) + share[1:]
            assert tuple(out[f"local_mu{stage}"][k]) == share, k
            assert tuple(out[f"local_ema{stage}"][k]) == (
                share if stage == 2 else tuple(v.shape)), k
        resumed = out[f"resumed{stage}"]
        assert resumed["step"] == want["step"]
        for part in ("mu", "nu"):
            for k, v in want["opt"][part].items():
                assert torch.equal(resumed["opt"][part][k], v), k
        for k, v in want["ema"]["params"].items():
            assert torch.equal(resumed["ema"]["params"][k], v), k


def test_tp_forward_matches_replicated(ranks, one_process):
    for out in ranks["out"]:
        np.testing.assert_allclose(out["tp"].numpy(), one_process["tp"].numpy(),
                                   atol=2e-5)
    # the tiny UNet's transformer blocks of 8 and 16 heads, halved a rank
    assert ranks["out"][0]["tp_heads"] == [4, 8]


def _flax_unet_params():
    cfg = jax_tiny_unet_config()
    b, hw = 1, 16
    args = (np.zeros((b, hw, hw, 4)), np.zeros((b,)),
            np.zeros((b, 77, cfg.cross_attention_dim)), np.zeros((b, 64)),
            np.zeros((b, 6)), np.zeros((b, hw, hw, cfg.condition_channels)))
    return jax.eval_shape(lambda: FlaxUNet(config=cfg).init(jax.random.PRNGKey(0), *args))


def _placement(spec, flax_shape, local_ids):
    """A JAX spec of a flax leaf, as a placement of the converted tensor
    whose elements are the leaf's element ids."""
    axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
    if not axes:
        return Replicate()
    (axis,) = axes
    along = np.unravel_index(local_ids, flax_shape)[axis]
    for d in range(local_ids.ndim):
        shape = [1] * local_ids.ndim
        shape[d] = local_ids.shape[d]
        if np.array_equal(along, np.broadcast_to(
                np.arange(local_ids.shape[d]).reshape(shape), local_ids.shape)):
            return Shard(d)
    raise AssertionError(f"axis {axis} of {flax_shape} is no one dim of "
                         f"{local_ids.shape}")


def test_tp_plan_matches_jax_unet_tp_shardings():
    """At 4 model ranks (tests/test_tp.py's (2, 4) mesh), each tensor of the
    port's state dict placed as JAX places the flax leaf it converts from.
    Every flax element gets an id of its own (exact in fp32), so each
    converted tensor names its leaf and where each element came from."""
    params = _flax_unet_params()
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = jax.tree.leaves(unet_tp_shardings(params, mesh))
    bases = np.cumsum([0] + [int(np.prod(leaf.shape)) for _, leaf in flat])
    assert bases[-1] < 2 ** 24
    ids = jax.tree_util.tree_unflatten(
        jax.tree.structure(params),
        [np.arange(lo, hi, dtype=np.float64).reshape(leaf.shape)
         for (_, leaf), lo, hi in zip(flat, bases, bases[1:])])
    want = {}
    for k, t in state_dict_from_flax(ids["params"]).items():
        first = int(t.min())
        i = int(np.searchsorted(bases, first, side="right")) - 1
        want[k] = _placement(specs[i].spec, flat[i][1].shape,
                             t.numpy().astype(np.int64) - first)
    unet = UNet2DConditionModel(tcfg.tiny_unet_config())
    plan = unet_tp_plan(unet, 4)
    assert sorted(plan) == sorted(unet.state_dict()) == sorted(want)
    assert want == plan
    assert sum(p == Shard(0) for p in plan.values()) > 0
    assert sum(p == Shard(1) for p in plan.values()) > 0


def test_shard_leading_divisible_matches_jax():
    """The rule on the 8-device data mesh, for every tensor of the tiny
    UNet's state dict and every flax leaf it converts from."""
    mesh = jax_make_mesh()
    assert mesh.shape["data"] == 8
    params = _flax_unet_params()
    sd = {k: v.numpy() for k, v in UNet2DConditionModel(
        tcfg.tiny_unet_config()).state_dict().items()}
    for tree in (sd, jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params)):
        ours = shard_leading_divisible(tree, 8)
        theirs = jax_shard_leading_divisible(tree, mesh)
        as_placement = jax.tree.map(
            lambda s: Shard(0) if s.spec == P("data") else Replicate(), theirs)
        assert jax.tree.leaves(ours) == jax.tree.leaves(as_placement)
    assert Shard(0) in shard_leading_divisible(sd, 8).values()
    assert Replicate() in shard_leading_divisible(sd, 8).values()
