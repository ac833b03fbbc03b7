"""Per-step canvas checkpoints and resume: the port's tiny pipeline against
the JAX package's, same weights, a 2-tile input (64x96 px at tile_size
64), 3 steps, `host_loop_tile_threshold` 0 on both sides so that a
`checkpoint_dir` is kept. The canvases (`canvas_step%04d.npy`, NHWC fp32)
agree with JAX's within 1e-4 at every step; a resume runs only the steps
whose canvas is missing and gives the uninterrupted run's latents; a run
whose caption, seed or weights differ drops the stale canvases; at or
below the threshold the directory is ignored with a warning."""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.config import PipelineConfig as JaxPipelineConfig
from faithdiff_tpu.pipelines.factory import \
    build_tiny_pipeline as jax_build_tiny_pipeline
from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.pipelines import build_tiny_pipeline
from faithdiff_tpu_torch.utils.convert import state_dict_from_flax
from port_parity import tiny_restore_params

SEED, STEPS = 2, 3
H, W = 64, 96
NAMES = [f"canvas_step{i:04d}.npy" for i in range(STEPS)]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The tiny models run no faster on more threads, and in the 6-worker
    test run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    unet, vae, de = tiny_restore_params()
    root = tmp_path_factory.mktemp("canvas")
    jpipe = jax_build_tiny_pipeline(
        pipeline_config=JaxPipelineConfig(tile_size=64, num_inference_steps=STEPS),
        unet_params=unet, vae_params=vae, denoise_encoder_params=de)
    tpipe = build_tiny_pipeline(
        pipeline_config=tcfg.PipelineConfig(tile_size=64, num_inference_steps=STEPS),
        unet_state_dict=state_dict_from_flax(unet),
        vae_state_dict=state_dict_from_flax(vae),
        denoise_encoder_state_dict=state_dict_from_flax(de), device="cpu")
    jpipe.host_loop_tile_threshold = tpipe.host_loop_tile_threshold = 0
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    pe = rng.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 64)).astype(np.float32)
    # start_point "noise": both sides draw the same torch.Generator latents
    jax_dir = str(root / "jax")
    jpipe(img, jnp.asarray(pe), jnp.asarray(pooled), seed=SEED,
          output_type="latent", noise_source="torch", start_point="noise",
          checkpoint_dir=jax_dir)
    calls = []
    tpipe.unet.register_forward_pre_hook(lambda m, a: calls.append(a[0].shape[0]))
    port_dir = root / "port"
    full = tpipe(img, pe, pooled, seed=SEED, output_type="latent",
                 start_point="noise", checkpoint_dir=str(port_dir)).numpy()
    return dict(tpipe=tpipe, img=img, pe=pe, pooled=pooled, jax_dir=jax_dir,
                port_dir=port_dir, calls=calls, full=full)


def _run(s, ck, **kw):
    args = dict(seed=SEED, output_type="latent", start_point="noise",
                checkpoint_dir=str(ck))
    args.update(kw)
    s["calls"].clear()
    pe = args.pop("pe", s["pe"])
    return s["tpipe"](s["img"], pe, s["pooled"], **args).numpy()


def _canvases(d):
    return sorted(n for n in os.listdir(d) if n.startswith("canvas_step"))


def _finished_run(setup, tmp_path):
    """A copy of the uninterrupted run's checkpoint directory."""
    ck = tmp_path / "ck"
    shutil.copytree(setup["port_dir"], ck)
    return ck


def test_canvases_match_jax(setup):
    port = setup["port_dir"]
    assert _canvases(port) == _canvases(setup["jax_dir"]) == NAMES
    for name in NAMES:
        got = np.load(port / name)
        want = np.load(os.path.join(setup["jax_dir"], name))
        assert got.dtype == np.float32 and got.shape == (1, H // 8, W // 8, 4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with open(port / "canvas_meta.json") as f:
        meta = json.load(f)
    with open(os.path.join(setup["jax_dir"], "canvas_meta.json")) as f:
        assert sorted(meta) == sorted(json.load(f))
    assert meta["noise_source"] == "torch"
    np.testing.assert_array_equal(np.load(port / NAMES[-1]), setup["full"])


def test_resume_runs_only_the_missing_step(setup, tmp_path):
    ck = _finished_run(setup, tmp_path)
    os.remove(ck / NAMES[-1])
    out = _run(setup, ck)
    assert setup["calls"] == [4]                     # one step, 2 tiles x CFG
    np.testing.assert_array_equal(out, setup["full"])


def test_resume_after_the_last_step_goes_straight_to_decode(setup, tmp_path):
    out = _run(setup, _finished_run(setup, tmp_path))
    assert setup["calls"] == []
    np.testing.assert_array_equal(out, setup["full"])


@pytest.mark.parametrize("change", ["caption", "seed", "weight"])
def test_stale_canvases_are_dropped(setup, tmp_path, change):
    ck = _finished_run(setup, tmp_path)
    np.save(ck / "canvas_step0009.npy", np.zeros(1, np.float32))
    with open(ck / "canvas_meta.json") as f:
        before = json.load(f)
    unet = setup["tpipe"].unet
    smallest = min(unet.state_dict().values(), key=lambda v: v.numel())
    saved = smallest.clone()
    kw = {"caption": dict(pe=setup["pe"] + 0.25), "seed": dict(seed=SEED + 1),
          "weight": {}}[change]
    try:
        if change == "weight":
            smallest.add_(0.5)
        _run(setup, ck, **kw)
    finally:
        smallest.copy_(saved)
    assert setup["calls"] == [4] * STEPS
    assert _canvases(ck) == NAMES
    with open(ck / "canvas_meta.json") as f:
        after = json.load(f)
    key = {"caption": "cond_hash", "seed": "seed", "weight": "params_fp"}[change]
    assert after[key] != before[key]
    assert {k for k in after if after[k] != before[k]} <= {key, "init_latents_hash"}


def test_at_or_below_the_threshold_nothing_is_written(setup, tmp_path):
    tpipe = setup["tpipe"]
    tpipe.host_loop_tile_threshold = 2              # the input has 2 tiles
    try:
        with pytest.warns(UserWarning, match="checkpoint_dir is ignored"):
            out = _run(setup, tmp_path / "ck")
    finally:
        tpipe.host_loop_tile_threshold = 0
    assert not os.path.exists(tmp_path / "ck")
    np.testing.assert_array_equal(out, setup["full"])
