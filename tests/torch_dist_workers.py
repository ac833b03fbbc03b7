"""The multi-process side of `tests/test_torch_parallel.py`: what each of N
gloo ranks runs (spawned processes import this module, which imports no
JAX), and the one-process counterparts the test holds them against. All
at the tiny configs, fp32, on the CPU."""
import os

import numpy as np
import torch
import torch.distributed as dist

from faithdiff_tpu_torch import config as tcfg
from faithdiff_tpu_torch.config import PipelineConfig
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.models.vae import AutoencoderKL, DenoiseEncoder
from faithdiff_tpu_torch.parallel import distributed
from faithdiff_tpu_torch.parallel.tp import apply_tp
from faithdiff_tpu_torch.pipelines.factory import build_tiny_pipeline, random_init_
from faithdiff_tpu_torch.training.checkpoint import CheckpointManager, state_to_dict
from faithdiff_tpu_torch.training.train import init_train_state, make_train_step

# 64 x 128 px at 64 px tiles: 8 x 16 latents, 3 tiles of 8 x 8 (padded to
# 4 over 2 ranks); one chunk, and chunks of 2 (the lazy LQ path)
RESTORE_HW, TILE_PX, RESTORE_STEPS, CHUNKS = (64, 128), 64, 2, (None, 2)
TRAIN_BATCH, TRAIN_RES, TRAIN_STEPS = 4, 16, 2


def restore_pipe(tile_chunk=None, tile_group=None):
    return build_tiny_pipeline(
        pipeline_config=PipelineConfig(tile_size=TILE_PX,
                                       num_inference_steps=RESTORE_STEPS),
        device="cpu", tile_chunk=tile_chunk, tile_group=tile_group)


def restore_input():
    return np.random.default_rng(0).integers(0, 256, RESTORE_HW + (3,), dtype=np.uint8)


def restore(pipe):
    return pipe(restore_input(), torch.zeros((1, 77, 64)), torch.zeros((1, 64)),
                seed=3, output_type="latent")


def train_state(stage: int, data_parallel: bool):
    unet = UNet2DConditionModel(tcfg.tiny_unet_config())
    de = DenoiseEncoder(tcfg.tiny_denoise_encoder_config())
    vae = AutoencoderKL(tcfg.tiny_vae_config())
    for i, m in enumerate((unet, de, vae)):
        random_init_(m, torch.Generator().manual_seed(i))
    # no tensor at zero (chip_smoke.py's training checks do the same for
    # the adapters): a zero-initialised fusion output gets exact-zero, then
    # ~1e-8 gradients, where AdamW's g / (|g| + eps) turns the sums'
    # rounding into percent-level differences; and a zero bias is, after
    # two steps, two AdamW updates (~2 lr) that a relative tolerance
    # measures against their own size
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in (unet, de):
            for p in m.parameters():
                if p.ndim > 1 and not p.any():
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
                elif p.ndim == 1 and not p.any():
                    p.normal_(0.0, 0.1, generator=gen)
    vae.requires_grad_(False)
    # AdamW's eps at 1e-3, not 1e-8: some gradients are zero in exact
    # arithmetic and rounding noise in floats (the attention's key bias,
    # to which softmax is blind), and g / (|g| + 1e-8) would scale that
    # noise, which differs between one process and two, to +-lr updates
    cfg = tcfg.TrainConfig(stage=stage, grad_accum=1, lr_warmup_steps=0,
                           ema_update_interval=1, adam_epsilon=1e-3)
    state = init_train_state(cfg, unet, de, data_parallel)
    return state, make_train_step(unet, de, vae, cfg, compute_dtype=torch.float32)


def train_batches():
    r = np.random.default_rng(4)
    b, res = TRAIN_BATCH, TRAIN_RES
    return [{"hr": r.uniform(-1, 1, (b, res, res, 3)).astype(np.float32),
             "lq": r.uniform(-1, 1, (b, res, res, 3)).astype(np.float32),
             "prompt_embeds": r.standard_normal((b, 77, 64)).astype(np.float32),
             "pooled_embeds": r.standard_normal((b, 64)).astype(np.float32),
             "add_time_ids": np.zeros((b, 6), np.float32)}
            for _ in range(TRAIN_STEPS)]


def train(state, step, rows=None):
    gen = torch.Generator().manual_seed(11)
    for b in train_batches():
        step(state, b, gen, rows=rows)
    return state


def tp_inputs():
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    cfg = tcfg.tiny_unet_config()
    return (mk(2, 4, 16, 16), torch.full((2,), 500.0), mk(2, 77, cfg.cross_attention_dim),
            mk(2, 64), torch.zeros((2, 6)), mk(2, cfg.condition_channels, 16, 16))


def tp_unet():
    unet = UNet2DConditionModel(tcfg.tiny_unet_config())
    random_init_(unet, torch.Generator().manual_seed(5))
    return unet.eval().requires_grad_(False)


def rank_main(rank: int, world: int, port: int, out_dir: str, one_ckpt: dict):
    """Everything a rank runs, in one process group; results go to
    `<out_dir>/rank<r>.pt`."""
    torch.set_num_threads(1)
    distributed.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = {"slice": distributed.local_batch_slice(TRAIN_BATCH)}
    try:
        for chunk in CHUNKS:
            pipe = restore_pipe(chunk, dist.group.WORLD)
            out[f"restore_{chunk}"] = restore(pipe)
        for stage in (1, 2):
            state, step = train_state(stage, data_parallel=True)
            train(state, step, distributed.local_batch_slice(TRAIN_BATCH))
            ckpt = CheckpointManager(os.path.join(out_dir, f"stage{stage}"),
                                     save_interval_steps=1)
            ckpt.save(TRAIN_STEPS, state)
            # resume from the one-process run's checkpoint on these ranks
            CheckpointManager(one_ckpt[stage]).restore(state)
            out[f"resumed{stage}"] = state_to_dict(state)
            out[f"local_mu{stage}"] = {k: v.shape for k, v in state.opt.mu.items()}
            out[f"local_ema{stage}"] = {k: v.shape for k, v in state.ema.params.items()}
        unet = apply_tp(tp_unet())
        with torch.no_grad():
            out["tp"] = unet(*tp_inputs())
        out["tp_heads"] = sorted({m.heads for m in unet.modules() if hasattr(m, "heads")
                                  and hasattr(m, "to_q")})
    finally:
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
