"""Command-line entry points (counterpart of `faithdiff_tpu/cli.py`).

    python -m faithdiff_tpu_torch.cli restore --img_dir in/ --save_dir out/ \\
        [--checkpoint_dir ckpts/] [--tokenizer_dir sdxl/] [--json_dir caps/] \\
        [--negative_prompt TEXT] [--canvas_resume_dir resume/] \\
        [--upscale 2] [--use_tile_vae] [--hdr 0.5] [--use_fp8]
    python -m faithdiff_tpu_torch.cli train --output_dir run/ \\
        [--stage 1|2] [--synthetic_data | --hr_dir HR --lr_dir LR] [...]
    python -m faithdiff_tpu_torch.cli embed --caption_dir caps/ \\
        --save_dir embeds/ [--tokenizer_dir sdxl/] [--text_encoder_dir T]
    python -m faithdiff_tpu_torch.cli caption --img_dir in/ --save_dir caps/ \\
        --captioner_dir ckpts/captioner [--use_bsrnet]
    python -m faithdiff_tpu_torch.cli metrics --sr_dir out/ [--gt_dir gt/] \\
        [--lpips_weights W] [--fid_weights W] [...] [--fit_niqe_dir D]

`restore` takes the JAX CLI's flags with the same defaults and runs its
loop: every `*.png` of `--img_dir` in sorted order (8- and 16-bit, any
color type, interlaced or not, read as PIL's `convert("RGB")` reads
them), skipping those whose output exists; optional HDR, then a Pillow-exact LANCZOS upscale, a
replicate pad to /8, the pipeline, the crop back and a PNG write.
`--checkpoint_dir` reads what `faithdiff_tpu_torch.utils.convert_cli`
writes (`unet/`, `vae/`, `denoise_encoder/`, `text_encoders/` of
safetensors files); a missing directory means a seeded random init of
that model. With `--tokenizer_dir` (SDXL's `tokenizer/` and
`tokenizer_2/`) and `text_encoders/`, the trimmed caption of
`--json_dir` and `--negative_prompt` go through the two CLIP text towers;
without them the prompt embeddings are zeros, as in the JAX CLI.
`--canvas_resume_dir` keeps each step's canvas of a restore above
`host_loop_tile_threshold` tiles in a directory per image, from which a
re-run resumes. The pipeline runs `TILE_CHUNK` tiles a UNet call.
`--use_fp8` stores the UNet's weights in float8_e4m3fn and upcasts each
where its layer runs (`pipelines.factory.build_pipeline(use_fp8=True)`).

`caption` runs the JAX CLI's loop: the LLaVA-1.5 captioner of
`--captioner_dir` (what `convert_cli --llava --clip_vision` writes, int8 as
`CaptionAgent.from_checkpoint` defaults), then every file of `--img_dir`
in sorted order, skipping those whose JSON exists, one image a caption with
seed 0, written as `{"caption": ...}` to `<save_dir>/<stem>.json`: the
captions `restore --json_dir` reads. `--use_bsrnet` is parsed and not
applied, as in the JAX CLI (a warning says so). Every command runs on the
CUDA card unless `--device cpu` is given.

`train` runs `training/runner.main` (the two-stage FaithDiff trainer;
its flags are the JAX runner's, see that module). `metrics` runs
`eval/metrics.main` (the ten IQA metrics of the reference protocol over
`--sr_dir` [`--gt_dir`], each learned one gated on its weights file; its
flags are the JAX harness's, plus `--device`).

`restore --tile_devices N` splits each UNet call's tiles over N cards:
run it under `torchrun --nproc_per_node N`, whose `WORLD_SIZE` must be N
(checked before any weight is read); each rank runs its share of the
tiles, every rank holds the same canvas, and rank 0 writes the PNGs.
`train` under torchrun trains data-parallel (see `training/runner.py`).

Inputs are PNG or JPEG files (`*.png`, `*.jpg`, `*.jpeg`; `caption` takes
every file of `--img_dir`), told apart by their first bytes and decoded by
the port itself as Pillow's `convert("RGB")` decodes them (`utils/png`,
`utils/jpeg`); each one's header is checked before any weight is read.
Outputs are PNG.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import torch

from .captioner.agent import CaptionAgent
from .config import (CLIPTextConfig, PipelineConfig,
                     tiny_denoise_encoder_config, tiny_text_encoder_configs,
                     tiny_unet_config, tiny_vae_config)
from .models.clip_text import SDXLTextEncoder
from .models.tokenizer import HashTokenizer, SDXLTokenizer
from .parallel import distributed
from .pipelines.factory import build_pipeline, random_init_
from .training.text_embeds import precompute_embeds, trim_caption
from .utils.image import check_image_size, create_hdr_effect
from .utils.png import check_image, read_rgb, write_png
from .utils.resample import resize_lanczos
from .utils.safetensors import load_dir

# tiles per UNet call of the restore: the chunk of the lowest UNet time per
# tile whose peak leaves 40 GiB of an 80 GB card to the captioner
# (`chip_smoke.py` tile_chunk_sweep on an H100, PERF.md: 81.8 ms a tile at
# 8, 139 ms at 12, where the 77-token cross-attention's score matrix
# passes the gate of `ops.attention.chunked_attention`)
TILE_CHUNK = 8


def build_text_encoder(tiny: bool, device, state_dict=None,
                       seed: int = 0) -> SDXLTextEncoder:
    """Both CLIP text towers on `device`: the full-width SDXL pair in bf16,
    or under `tiny` the JAX CLI's tiny pair in fp32; weights from
    `state_dict` (strict) or a seeded random init."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("text towers: device 'cuda' requested but CUDA is "
                           "not available (pass --device cpu)")
    configs = (tiny_text_encoder_configs() if tiny else
               (CLIPTextConfig.sdxl_text_encoder(),
                CLIPTextConfig.sdxl_text_encoder_2()))
    with device:
        enc = SDXLTextEncoder(*configs, dtype=torch.float32 if tiny
                              else torch.bfloat16)
    if state_dict is None:
        random_init_(enc, torch.Generator(device=device).manual_seed(seed))
    else:
        enc.load_state_dict(state_dict, strict=True)
    return enc.eval().requires_grad_(False)


def _add_restore_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's restore flags and defaults, and `--device`."""
    p.add_argument("--img_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--json_dir", default=None,
                   help="caption JSONs per image")
    p.add_argument("--upscale", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--latent_tiled_size", type=int, default=1024,
                   help="pixel-space tile edge (latent = /8)")
    p.add_argument("--latent_tiled_overlap", type=float, default=0.5)
    p.add_argument("--color_fix", choices=["wavelet", "adain", "nofix"],
                   default="wavelet")
    p.add_argument("--start_point", choices=["lr", "noise"], default="lr")
    p.add_argument("--use_tile_vae", action="store_true")
    p.add_argument("--use_fp8", action="store_true",
                   help="store UNet weights as float8 (min-memory mode, "
                        "the reference --use_fp8)")
    p.add_argument("--hdr", type=float, default=0.0)
    p.add_argument("--checkpoint_dir", default=None,
                   help="dir with converted params (unet/ vae/ "
                        "denoise_encoder/ text_encoders/); omit for random "
                        "init")
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with SDXL's tokenizer/ and tokenizer_2/; with "
                        "text_encoders/ the prompts are encoded")
    p.add_argument("--tile_devices", type=int, default=1,
                   help="cards that split the tiles; N > 1 runs under "
                        "torchrun --nproc_per_node N")
    p.add_argument("--negative_prompt", default="",
                   help="real negative prompt text; empty keeps zero "
                        "negative embeds (needs the text towers)")
    p.add_argument("--canvas_resume_dir", default=None,
                   help="per-step canvas checkpoints, a directory per "
                        "image: a crashed large restore resumes at its next "
                        "step")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test-config models in fp32")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on")


def _refuse_unserved(args, images) -> None:
    """Raise, before any weight is read, on a `--tile_devices` other than
    the processes torchrun started (`WORLD_SIZE`, 1 without it) and on an
    input that is no PNG or JPEG the decoders take (`check_image`)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.tile_devices != world:
        raise ValueError(f"--tile_devices {args.tile_devices} under WORLD_SIZE="
                         f"{world}: run --tile_devices N under torchrun "
                         "--nproc_per_node N")
    for path in images:
        check_image(path)


def load_checkpointed_pipeline(args):
    """The pipeline of the restore flags, its weights from
    `--checkpoint_dir` where a model's directory exists, `TILE_CHUNK`
    tiles a UNet call."""
    def maybe(name):
        if not args.checkpoint_dir:
            return None
        full = os.path.join(args.checkpoint_dir, name)
        return load_dir(full) if os.path.isdir(full) else None

    pipeline_config = PipelineConfig(
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale,
        tile_size=args.latent_tiled_size,
        tile_overlap=args.latent_tiled_overlap,
        start_point=args.start_point,
        color_fix=args.color_fix,
        use_tiled_vae=args.use_tile_vae,
    )
    if args.tiny:
        kwargs = dict(unet_config=tiny_unet_config(),
                      vae_config=tiny_vae_config(),
                      denoise_encoder_config=tiny_denoise_encoder_config(),
                      dtype=torch.float32)
    else:
        kwargs = dict(dtype=torch.bfloat16)
    return build_pipeline(
        pipeline_config=pipeline_config,
        unet_state_dict=maybe("unet"),
        vae_state_dict=maybe("vae"),
        denoise_encoder_state_dict=maybe("denoise_encoder"),
        device=args.device, tile_chunk=TILE_CHUNK, use_fp8=args.use_fp8,
        **kwargs)


def make_text_encoder(args):
    """text -> (prompt embeds, pooled), fp32, over the two towers of
    `<checkpoint_dir>/text_encoders/` and the tokenizers of
    `--tokenizer_dir`; None without either (zero embeds)."""
    te_dir = (os.path.join(args.checkpoint_dir, "text_encoders")
              if args.checkpoint_dir else "")
    if not (args.tokenizer_dir and te_dir and os.path.isdir(te_dir)):
        if args.tokenizer_dir:
            print(f"WARNING: --tokenizer_dir without {te_dir or '--checkpoint_dir'}"
                  "/text_encoders; using zero prompt embeds")
        return None
    tok = SDXLTokenizer(os.path.join(args.tokenizer_dir, "tokenizer"),
                        os.path.join(args.tokenizer_dir, "tokenizer_2"))
    enc = build_text_encoder(args.tiny, args.device, load_dir(te_dir))

    @torch.no_grad()
    def encode(text: str):
        ids_1, ids_2 = tok(text)
        pe, pooled = enc(torch.from_numpy(ids_1), torch.from_numpy(ids_2))
        return pe.float(), pooled.float()

    return encode


def cmd_restore(argv) -> int:
    p = argparse.ArgumentParser("restore")
    _add_restore_args(p)
    args = p.parse_args(argv)
    images = sorted(sum([glob.glob(os.path.join(args.img_dir, e))
                         for e in ("*.png", "*.jpg", "*.jpeg")], []))
    _refuse_unserved(args, images)
    if args.tile_devices > 1:
        distributed.init_distributed(device=args.device)
    lead = distributed.rank() == 0

    pipe = load_checkpointed_pipeline(args)
    if args.tile_devices > 1:
        pipe.tile_group = torch.distributed.group.WORLD
    encode = make_text_encoder(args)
    if args.negative_prompt and encode is None:
        print("WARNING: --negative_prompt ignored (no text-encoder "
              "checkpoint); using zero negative embeds")
    neg_pe = neg_pooled = None
    if args.negative_prompt and encode is not None:
        neg_pe, neg_pooled = encode(args.negative_prompt)
    os.makedirs(args.save_dir, exist_ok=True)
    cross_dim = pipe.unet.config.cross_attention_dim
    pooled_dim = (pipe.unet.config.projection_class_embeddings_input_dim
                  - 6 * pipe.unet.config.addition_time_embed_dim)
    zero_embeds = (torch.zeros((1, 77, cross_dim)), torch.zeros((1, pooled_dim)))
    for path in images:
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.save_dir, f"{name}.png")
        if os.path.exists(out_path):
            print(f"skip {name}")
            continue
        t0 = time.perf_counter()
        img = read_rgb(path)
        caption = ""
        if args.json_dir:
            jpath = os.path.join(args.json_dir, f"{name}.json")
            if os.path.exists(jpath):
                with open(jpath) as f:
                    caption = trim_caption(json.load(f)["caption"])
        if caption and encode is None:
            print(f"caption of {name} not used (no --tokenizer_dir and "
                  f"text_encoders/ checkpoint): {caption!r}")
        t1 = time.perf_counter()
        prompt_embeds, pooled = (zero_embeds if encode is None
                                 else encode(caption))
        ck = ({"checkpoint_dir": os.path.join(args.canvas_resume_dir, name)}
              if args.canvas_resume_dir else {})
        t1e = time.perf_counter()
        if args.hdr > 0:
            img = create_hdr_effect(img, args.hdr, device=args.device)
        t2 = time.perf_counter()
        h, w = img.shape[:2]
        img = resize_lanczos(img, (w * args.upscale, h * args.upscale))
        padded, w0, h0, _, _ = check_image_size(img)
        t3 = time.perf_counter()
        out = pipe(padded, prompt_embeds, pooled, seed=args.seed,
                   negative_prompt_embeds=neg_pe,
                   negative_pooled_prompt_embeds=neg_pooled,
                   output_type="uint8", **ck)
        t4 = time.perf_counter()
        if not lead:
            continue                    # every rank holds the same image
        write_png(out_path, out[:h0, :w0])
        t5 = time.perf_counter()
        print(f"restored {name} -> {out_path}: read_s={t1 - t0:.4f} "
              f"encode_s={t1e - t1:.4f} hdr_s={t2 - t1e:.4f} "
              f"resize_s={t3 - t2:.4f} "
              f"pipeline_s={t4 - t3:.4f} write_s={t5 - t4:.4f}")
    return 0


def cmd_embed(argv) -> int:
    """Stem-keyed prompt embeddings for training, and the empty prompt's
    `__null__.npz` that caption dropout takes."""
    p = argparse.ArgumentParser("embed")
    p.add_argument("--caption_dir", required=True,
                   help=".txt or .json caption files, one per sample stem")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with tokenizer/ tokenizer_2/; omit for the "
                        "hash tokenizer (smoke runs only)")
    p.add_argument("--text_encoder_dir", default=None,
                   help="the two towers as convert_cli writes them "
                        "(text_encoders/); omit for random init (smoke runs "
                        "only)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny text towers in fp32")
    p.add_argument("--no_trim", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device the towers run on")
    args = p.parse_args(argv)

    if args.tokenizer_dir:
        tok = SDXLTokenizer(os.path.join(args.tokenizer_dir, "tokenizer"),
                            os.path.join(args.tokenizer_dir, "tokenizer_2"))
    else:
        print("WARNING: no --tokenizer_dir; using the hash tokenizer "
              "(smoke runs only)")
        tok = HashTokenizer(vocab_size=128 if args.tiny else 49408)
    if args.text_encoder_dir:
        enc = build_text_encoder(args.tiny, args.device,
                                 load_dir(args.text_encoder_dir))
    else:
        print("WARNING: no --text_encoder_dir; random-init towers "
              "(smoke runs only)")
        enc = build_text_encoder(args.tiny, args.device)

    @torch.no_grad()
    def encode(ids_1, ids_2):
        return enc(torch.from_numpy(ids_1), torch.from_numpy(ids_2))

    files = sorted(sum([glob.glob(os.path.join(args.caption_dir, e))
                        for e in ("*.txt", "*.json")], []))
    n = precompute_embeds(files, args.save_dir, tok, encode,
                          trim=not args.no_trim)
    print(f"wrote {n} embedding files to {args.save_dir} "
          "(incl. the null-prompt embedding)")
    return 0


def cmd_caption(argv) -> int:
    """Caption JSONs for the images of a directory (`faithdiff_tpu/cli.py`
    `cmd_caption`)."""
    p = argparse.ArgumentParser("caption")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--captioner_dir", required=True,
                   help="converted captioner (llama/ projector/ vision/ "
                        "tokenizer/ [lora/]), as convert_cli writes it")
    p.add_argument("--use_bsrnet", action="store_true",
                   help="parsed and not applied, as in the JAX CLI")
    p.add_argument("--device", default="cuda",
                   help="torch device the captioner runs on")
    args = p.parse_args(argv)
    paths = sorted(q for q in glob.glob(os.path.join(args.img_dir, "*"))
                   if os.path.isfile(q))
    for path in paths:
        check_image(path)
    if args.use_bsrnet:
        print("WARNING: --use_bsrnet is not applied (the JAX CLI parses it "
              "and never reads it); the images are captioned as they are")
    agent = CaptionAgent.from_checkpoint(args.captioner_dir, device=args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.save_dir, f"{name}.json")
        if os.path.exists(out_path):
            print(f"skip {name}")
            continue
        t0 = time.perf_counter()
        caption = agent.caption(read_rgb(path), seed=0)
        with open(out_path, "w") as f:
            json.dump({"caption": caption}, f)
        print(f"captioned {name}: caption_s={time.perf_counter() - t0:.4f} "
              f"{caption[:80]!r}")
    return 0


def cmd_train(argv) -> int:
    from .training import runner

    runner.main(argv)
    return 0


def cmd_metrics(argv) -> int:
    from .eval.metrics import main as metrics_main

    metrics_main(argv)
    return 0


COMMANDS = {"restore": cmd_restore, "caption": cmd_caption,
            "embed": cmd_embed, "train": cmd_train, "metrics": cmd_metrics}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m faithdiff_tpu_torch.cli "
              f"{{{'|'.join(COMMANDS)}}} ...")
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
