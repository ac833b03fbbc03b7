"""Training runner (counterpart of `faithdiff_tpu/training/runner.py`;
the reference's `train_SDXL_stage_{1,2}.py`).

    python -m faithdiff_tpu_torch.cli train --output_dir run/ --stage 1 \\
        [--hr_dir HR --lr_dir LR --caption_dir CAP | --synthetic_data] \\
        [--embeds_dir E | --text_encoder_dir T --tokenizer_dir SDXL] \\
        [--pretrained_params_dir C] [--resume_from_checkpoint 1] [--device cpu]

Dataset (or synthetic batches) -> prompt embeddings -> the train step
(`training/train.py`) -> EMA -> checkpoints under `--output_dir` ->
periodic validation strips, on one CUDA card (or the CPU with `--device
cpu`). The flags and defaults are the JAX runner's, with `--device`, and
`--text_encoder_dir` / `--tokenizer_dir`, which the JAX runner reads but
never defines. As there, the loop counts micro-steps for
`max_train_steps`, `validation_steps`, `checkpointing_steps` and
`log_every`, and a resumed run restarts its data stream and its noise
generator from `--seed`. `--dtype float32` runs the forward in fp32, on
the card too (the flash kernels' fp32 instance).

Under torchrun (`torchrun --nproc_per_node N -m faithdiff_tpu_torch.cli
train ...`) the N processes form the JAX runner's data mesh, one card
each: every rank draws the same seeded global batch of
`--train_batch_size` rows (and the same noise) and steps on its
`parallel.distributed.local_batch_slice`; the gradients are averaged at
each optimizer step, with ZeRO sharding as the JAX runner has it (the
AdamW moments at both stages, the EMA too at stage 2; `training/train.py`).
Rank 0 logs, validates and writes the checkpoints, gathered whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import (DenoiseEncoderConfig, PipelineConfig, SchedulerConfig,
                      TrainConfig, UNetConfig, VAEConfig)
from ..models.unet import UNet2DConditionModel
from ..models.vae import AutoencoderKL, DenoiseEncoder
from ..parallel import distributed
from ..pipelines.factory import random_init_
from .checkpoint import CheckpointManager, load_params
from .train import init_train_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX runner's flags and defaults, plus `--device` and the two
    text-tower flags its `_make_embed_provider` reads."""
    p = argparse.ArgumentParser("faithdiff-train")
    p.add_argument("--stage", type=int, choices=[1, 2], default=1)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--hr_dir", default=None)
    p.add_argument("--lr_dir", default=None)
    p.add_argument("--caption_dir", default=None)
    p.add_argument("--embeds_dir", default=None,
                   help="precomputed prompt embeds (.npz per sample)")
    p.add_argument("--text_encoder_dir", default=None,
                   help="the two text towers as convert_cli writes them "
                        "(text_encoders/); with --tokenizer_dir captions are "
                        "encoded live")
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with SDXL's tokenizer/ and tokenizer_2/")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=None,
                   help="batch (default: 16 for stage 1, 2 for stage 2)")
    p.add_argument("--grad_accum", type=int, default=None,
                   help="micro-batch accumulation (default: 4 for stage 1, "
                        "16 for stage 2)")
    p.add_argument("--remat", type=int, choices=[0, 1], default=None,
                   help="gradient checkpointing for UNet + denoise_encoder "
                        "(default: on for stage 2, off for stage 1)")
    p.add_argument("--max_train_steps", type=int, default=6000)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--vis_learning_rate", type=float, default=5e-6)
    p.add_argument("--lr_scheduler", default="cosine")
    p.add_argument("--lr_warmup_steps", type=int, default=300)
    p.add_argument("--noise_offset", type=float, default=0.02)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--ema_update_interval", type=int, default=100)
    p.add_argument("--checkpointing_steps", type=int, default=2000)
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--validation_steps", type=int, default=500)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--val_dir", default=None,
                   help="dir of LQ validation PNGs (RealPhoto60-style)")
    p.add_argument("--val_num_images", type=int, default=4)
    p.add_argument("--pretrained_params_dir", default=None,
                   help="converted params to start from (unet/ "
                        "denoise_encoder/ vae/, as convert_cli writes them)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dataloader_workers", type=int, default=4,
                   help="parallel sample-decode threads (0 = synchronous)")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="batches prefetched ahead of the device step "
                        "(0 = no background prefetch)")
    p.add_argument("--synthetic_data", action="store_true",
                   help="random data (smoke runs without a dataset)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device the models train on")
    return p.parse_args(argv)


def _synthetic_batches(batch_size: int, res: int, cross_dim: int,
                       pooled_dim: int, seed: int) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "hr": rng.uniform(-1, 1, (batch_size, res, res, 3)).astype(np.float32),
            "lq": rng.uniform(-1, 1, (batch_size, res, res, 3)).astype(np.float32),
            "prompt_embeds": rng.standard_normal(
                (batch_size, 77, cross_dim)).astype(np.float32) * 0.02,
            "pooled_embeds": rng.standard_normal(
                (batch_size, pooled_dim)).astype(np.float32) * 0.02,
            "add_time_ids": np.tile(
                np.asarray([res, res, 0, 0, res, res], np.float32),
                (batch_size, 1)),
        }


def _make_embed_provider(args, cross_dim, pooled_dim):
    """The prompt-embedding source: a stem-keyed precomputed dir, the text
    towers run live, or zeros. A dropped caption ("") maps to the null
    prompt's embedding in every mode."""
    from .text_embeds import PromptEmbedProvider

    if args.embeds_dir:
        return PromptEmbedProvider.from_dir(args.embeds_dir)
    if args.text_encoder_dir and args.tokenizer_dir:
        from ..cli import build_text_encoder
        from ..models.tokenizer import SDXLTokenizer

        tok = SDXLTokenizer(os.path.join(args.tokenizer_dir, "tokenizer"),
                            os.path.join(args.tokenizer_dir, "tokenizer_2"))
        enc = build_text_encoder(False, args.device,
                                 load_params(args.text_encoder_dir))

        @torch.no_grad()
        def encode(ids_1, ids_2):
            return enc(torch.from_numpy(ids_1), torch.from_numpy(ids_2))

        return PromptEmbedProvider.from_towers(tok, encode)
    return PromptEmbedProvider.zeros(cross_dim, pooled_dim)


def _dataset_batches(args, cross_dim, pooled_dim,
                     provider=None) -> Iterator[dict]:
    from ..data.dataset import LocalPairedDataset, collate, discover_pairs

    hr, lr, caps = discover_pairs(args.hr_dir, args.lr_dir, args.caption_dir)
    ds = LocalPairedDataset(hr, lr, caps, resolution=args.resolution,
                            seed=args.seed)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in hr]
    provider = provider or _make_embed_provider(args, cross_dim, pooled_dim)

    workers = getattr(args, "dataloader_workers", 0)
    if workers > 0:
        # parallel decode + augment with a deterministic rng per draw
        from ..data.prefetch import ParallelSampleLoader

        class _WithStem:
            def __len__(self):
                return len(ds)

            def __getitem__(self, i, rng=None):
                return ds.__getitem__(i, rng=rng), stems[i]

        def _collate(pairs):
            batch = collate([p[0] for p in pairs])
            captions = batch.pop("captions")
            batch["prompt_embeds"], batch["pooled_embeds"] = provider.batch(
                [p[1] for p in pairs], captions)
            return batch

        yield from ParallelSampleLoader(
            _WithStem(), args.train_batch_size, _collate, seed=args.seed,
            num_workers=workers,
            depth=max(1, getattr(args, "prefetch_depth", 2)))
        return

    rng = np.random.default_rng(args.seed)
    n = len(ds)
    while True:
        idx = rng.integers(0, n, args.train_batch_size)
        samples = [ds[int(i)] for i in idx]
        batch = collate(samples)
        captions = batch.pop("captions")
        batch["prompt_embeds"], batch["pooled_embeds"] = provider.batch(
            [stems[int(i)] for i in idx], captions)
        yield batch


def resolve_stage_defaults(args) -> None:
    """Stage-dependent recipe defaults, in place: stage 1 batch 16, accum 4,
    remat off (the reference's launch); stage 2 batch 2, accum 16, remat
    on (the JAX package's memory-fit plan, effective batch 256 on 8
    devices)."""
    if args.train_batch_size is None:
        args.train_batch_size = 2 if args.stage == 2 else 16
    if args.grad_accum is None:
        args.grad_accum = 16 if args.stage == 2 else 4
    if args.remat is None:
        args.remat = 1 if args.stage == 2 else 0


def _check_device_and_ranks(args, device: torch.device) -> None:
    """Raise, before anything is built, on a card that is not there or a
    batch that torchrun's ranks (`WORLD_SIZE`) do not divide."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: device 'cuda' requested but CUDA is "
                           "not available (pass --device cpu)")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.train_batch_size % world:
        raise ValueError(f"--train_batch_size {args.train_batch_size} does not "
                         f"split over WORLD_SIZE={world} ranks")


def build_models(args, ucfg: UNetConfig, vcfg: VAEConfig,
                 dcfg: DenoiseEncoderConfig, device: torch.device):
    """The UNet, denoise encoder and VAE in fp32 on `device`: from
    `--pretrained_params_dir` (strict), or a seeded random init made on
    the device."""
    with device:
        unet = UNet2DConditionModel(ucfg)
        de = DenoiseEncoder(dcfg)
        vae = AutoencoderKL(vcfg)
    if args.pretrained_params_dir:
        for model, name in ((unet, "unet"), (de, "denoise_encoder"),
                            (vae, "vae")):
            model.load_state_dict(load_params(os.path.join(
                args.pretrained_params_dir, name)), strict=True)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        for model in (unet, de, vae):
            random_init_(model, gen)
    vae.eval().requires_grad_(False)
    return unet, de, vae


def main(argv=None, *, unet_config: Optional[UNetConfig] = None,
         vae_config: Optional[VAEConfig] = None,
         denoise_encoder_config: Optional[DenoiseEncoderConfig] = None):
    args = parse_args(argv)
    resolve_stage_defaults(args)
    device = torch.device(args.device)
    _check_device_and_ranks(args, device)
    distributed.init_distributed(device=args.device)
    data_parallel = torch.distributed.is_initialized()
    lead = distributed.rank() == 0
    ucfg = unet_config or UNetConfig()
    vcfg = vae_config or VAEConfig()
    dcfg = denoise_encoder_config or DenoiseEncoderConfig()
    if args.remat:
        ucfg = dataclasses.replace(ucfg, remat=True)
        dcfg = dataclasses.replace(dcfg, remat=True)
    cfg = TrainConfig(
        resolution=args.resolution,
        batch_size_per_device=args.train_batch_size,
        grad_accum=args.grad_accum,
        learning_rate=args.learning_rate,
        vis_learning_rate=args.vis_learning_rate,
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps,
        noise_offset=args.noise_offset,
        max_grad_norm=args.max_grad_norm,
        ema_update_interval=args.ema_update_interval,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        validation_steps=args.validation_steps,
        stage=args.stage,
        seed=args.seed,
    )
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    pooled_dim = ucfg.projection_class_embeddings_input_dim - \
        ucfg.addition_time_embed_dim * 6

    unet, de, vae = build_models(args, ucfg, vcfg, dcfg, device)
    state = init_train_state(cfg, unet, de, data_parallel)
    step_fn = make_train_step(unet, de, vae, cfg, SchedulerConfig(),
                              compute_dtype)

    ckpt = CheckpointManager(
        args.output_dir, max_to_keep=args.checkpoints_total_limit,
        save_interval_steps=args.checkpointing_steps)
    start_step = 0
    if args.resume_from_checkpoint:
        ckpt.restore(state)
        start_step = state.step
        if lead:
            print(f"resumed from step {start_step}")

    if args.synthetic_data or not args.hr_dir:
        batches = _synthetic_batches(
            args.train_batch_size, args.resolution, ucfg.cross_attention_dim,
            pooled_dim, args.seed)
    else:
        batches = _dataset_batches(args, ucfg.cross_attention_dim, pooled_dim)
    if getattr(args, "prefetch_depth", 0) > 0:
        # overlap host-side batch production with the device step
        from ..data.prefetch import PrefetchIterator

        batches = PrefetchIterator(iter(batches), depth=args.prefetch_depth)

    from .logging import MetricLogger

    logger = MetricLogger(os.path.join(args.output_dir, "logs")) if lead else None
    # the step's randomness, restarted from the seed on resume as in JAX
    generator = torch.Generator().manual_seed(args.seed + 1)
    # a rank's rows of each global batch
    share = ({"rows": distributed.local_batch_slice(args.train_batch_size)}
             if data_parallel else {})
    t0 = time.time()
    for step_idx in range(start_step, args.max_train_steps):
        batch = next(batches)
        metrics = step_fn(state, batch, generator, **share)
        if (step_idx + 1) % args.log_every == 0:
            loss = metrics["loss"]
            if data_parallel:          # the global batch's mean
                torch.distributed.all_reduce(loss)
                loss = loss / distributed.world()
            loss = float(loss)
            rate = args.log_every / (time.time() - t0)
            t0 = time.time()
            if lead:
                logger.log(step_idx + 1, {"train_loss": loss,
                                          "grad_norm": float(metrics["grad_norm"]),
                                          "it_per_s": rate})
                print(f"step {step_idx + 1} loss {loss:.4f} "
                      f"({rate:.2f} it/s)", flush=True)
        if args.val_dir and (step_idx + 1) % args.validation_steps == 0:
            shadow = state.ema_state_dict()       # gathered: a collective
            if lead:
                _run_validation(args, ucfg, vcfg, dcfg, state, shadow, vae,
                                step_idx + 1)
        ckpt.save(step_idx + 1, state, generator=generator)
    # orbax refuses a forced save at a step that exists (the JAX runner
    # then raises when the loop saved its last step): skip it
    if args.max_train_steps not in ckpt.all_steps():
        ckpt.save(args.max_train_steps, state, force=True, generator=generator)
    if lead:
        logger.close()
    if hasattr(batches, "close"):
        batches.close()             # stops the prefetch thread
    if lead:
        print("training done")
    return state


def _run_validation(args, ucfg, vcfg, dcfg, state, shadow, vae, step):
    """Restore a few validation images with the EMA parameters (bf16) and
    write their strip to `validation/step_{step}.png` (the reference's
    `train_SDXL_stage_1.py:127-195`); with MUSIQ weights
    (`eval/musiq.npz`, or pyiqa) the strips' mean MUSIQ is printed and
    named in the file, `step_{step}_musiq{mean:.3f}.png`, as in JAX."""
    import glob as _glob

    from ..data.dataset import read_image
    from ..pipelines.factory import build_pipeline
    from ..utils.png import write_png
    from ..utils.resample import resize_bicubic
    from .ema import EMAState, ema_copy_to

    like = {"unet." + k: v for k, v in state.unet.state_dict().items()}
    like.update({"denoise_encoder." + k: v
                 for k, v in state.denoise_encoder.state_dict().items()})
    ema = ema_copy_to(EMAState(shadow), like)

    def part(prefix):
        return {k[len(prefix):]: v for k, v in ema.items()
                if k.startswith(prefix)}

    pipe = build_pipeline(
        unet_config=dataclasses.replace(ucfg, remat=False),
        vae_config=vcfg,
        denoise_encoder_config=dataclasses.replace(dcfg, remat=False),
        pipeline_config=PipelineConfig(num_inference_steps=20,
                                       tile_size=args.resolution),
        unet_state_dict=part("unet."), vae_state_dict=vae.state_dict(),
        denoise_encoder_state_dict=part("denoise_encoder."),
        dtype=torch.bfloat16, device=args.device)
    paths = sorted(_glob.glob(os.path.join(args.val_dir, "*")))[
        : args.val_num_images]
    pooled_dim = ucfg.projection_class_embeddings_input_dim - \
        ucfg.addition_time_embed_dim * 6
    pe = torch.zeros((1, 77, ucfg.cross_attention_dim))
    pooled = torch.zeros((1, pooled_dim))
    outs = []
    for p in paths:
        img = resize_bicubic(read_image(p), (args.resolution, args.resolution))
        out = pipe(img.astype(np.float32) / 255.0, pe, pooled, seed=42)
        outs.append(np.uint8(np.clip(out, 0, 1) * 255))
    if outs:
        out_dir = os.path.join(args.output_dir, "validation")
        os.makedirs(out_dir, exist_ok=True)
        # MUSIQ quality signal, baked into the strip filename (the stage-2
        # protocol, `train_SDXL_stage_2.py:182-194`): eval/musiq.py when
        # converted weights exist, the pyiqa passthrough otherwise; a
        # scorer that fails leaves the plain name, as in JAX
        name = f"step_{step}.png"
        try:
            from ..eval.metrics import make_learned_metrics
            from ..eval.musiq import make_musiq

            musiq_fn = make_musiq(device=args.device)
            if musiq_fn is None:
                musiq_fn = make_learned_metrics(("musiq",)).get("musiq")
            if musiq_fn is not None:
                mean = float(np.mean([musiq_fn(o.astype(np.float32) / 255.0)
                                      for o in outs]))
                print(f"validation MUSIQ @ step {step}: {mean:.3f}")
                name = f"step_{step}_musiq{mean:.3f}.png"
        except Exception:
            pass
        write_png(os.path.join(out_dir, name), np.concatenate(outs, axis=1))
    del pipe
