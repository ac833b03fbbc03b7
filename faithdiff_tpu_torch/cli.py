"""Command-line entry points (counterpart of `faithdiff_tpu/cli.py`).

    python -m faithdiff_tpu_torch.cli restore --img_dir in/ --save_dir out/ \\
        [--checkpoint_dir ckpts/] [--upscale 2] [--use_tile_vae] [--hdr 0.5]

`restore` takes the JAX CLI's flags with the same defaults and runs its
loop: every `*.png` of `--img_dir` in sorted order, skipping those whose
output exists; optional HDR, then a Pillow-exact LANCZOS upscale, a
replicate pad to /8, the pipeline, the crop back and a PNG write.
`--checkpoint_dir` reads what `faithdiff_tpu_torch.utils.convert_cli`
writes (`unet/`, `vae/`, `denoise_encoder/` of safetensors files); a
missing directory means a seeded random init of that model. It runs on
the CUDA card unless `--device cpu` is given.

What the port does not serve yet raises NotImplementedError naming its
ROADMAP item: the `caption`, `embed`, `train` and `metrics` commands,
`--use_fp8`, `--canvas_resume_dir`, `--tile_devices` above 1,
`--tokenizer_dir` (without it the prompt embeddings are zeros, as in the
JAX CLI without a text encoder) and JPEG inputs.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import torch

from .config import (PipelineConfig, tiny_denoise_encoder_config,
                     tiny_unet_config, tiny_vae_config)
from .pipelines.factory import build_pipeline
from .utils.image import check_image_size, create_hdr_effect
from .utils.png import read_png, write_png
from .utils.resample import resize_lanczos
from .utils.safetensors import load_file

_TEXT_TOWERS = "ROADMAP §1.2 (CLIP text towers and tokenizer)"
_RESTORE_OPTIONS = "ROADMAP §1.1 (restore pipeline options)"
_NOT_YET = {
    "caption": "ROADMAP §1.3 (caption CLI, captioner weights and BSRNet)",
    "embed": _TEXT_TOWERS,
    "train": "ROADMAP §1.4 (training and data)",
    "metrics": "ROADMAP §1.6 (eval)",
}


def trim_caption(caption: str, drop_words: int = 3,
                 keep_sentences: int = 2) -> str:
    """Drop the first `drop_words` words and keep the first
    `keep_sentences` sentences (the trim the reference applies to LLaVA
    captions at training and at inference)."""
    words = caption.split(" ")
    caption = " ".join(words[drop_words:])
    sentences = caption.split(".")
    return ".".join(sentences[:keep_sentences]).strip()


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
                   help=f"not served yet: {_RESTORE_OPTIONS}")
    p.add_argument("--hdr", type=float, default=0.0)
    p.add_argument("--checkpoint_dir", default=None,
                   help="dir with converted params (unet/ vae/ "
                        "denoise_encoder/); omit for random init")
    p.add_argument("--tokenizer_dir", default=None,
                   help=f"not served yet: {_TEXT_TOWERS}")
    p.add_argument("--tile_devices", type=int, default=1,
                   help="1 only: multi-GPU tiles are ROADMAP §1.5")
    p.add_argument("--negative_prompt", default="",
                   help="needs the text towers; ignored with a warning")
    p.add_argument("--canvas_resume_dir", default=None,
                   help=f"not served yet: {_RESTORE_OPTIONS}")
    p.add_argument("--tiny", action="store_true",
                   help="tiny test-config models in fp32")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on")


def _refuse_unserved(args, images) -> None:
    """Raise on what this slice of the port does not serve, before any
    weight is read."""
    if args.use_fp8:
        raise NotImplementedError(f"--use_fp8: {_RESTORE_OPTIONS}")
    if args.canvas_resume_dir:
        raise NotImplementedError(f"--canvas_resume_dir: {_RESTORE_OPTIONS}")
    if args.tile_devices != 1:
        raise NotImplementedError(
            f"--tile_devices {args.tile_devices}: ROADMAP §1.5 (multi-GPU)")
    if args.tokenizer_dir:
        raise NotImplementedError(f"--tokenizer_dir: {_TEXT_TOWERS}")
    jpegs = [p for p in images if not p.lower().endswith(".png")]
    if jpegs:
        raise NotImplementedError(
            f"{jpegs[0]}: JPEG input, {_RESTORE_OPTIONS}: no JPEG decoder is "
            "known on the card's machine")


def load_checkpointed_pipeline(args):
    """The pipeline of the restore flags, its weights from
    `--checkpoint_dir` where a model's directory exists."""
    def maybe(name):
        if not args.checkpoint_dir:
            return None
        full = os.path.join(args.checkpoint_dir, name)
        if not os.path.isdir(full):
            return None
        files = sorted(glob.glob(os.path.join(full, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {full}")
        sd = {}
        for f in files:
            sd.update(load_file(f))
        return sd

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
        device=args.device, **kwargs)


def cmd_restore(argv) -> int:
    p = argparse.ArgumentParser("restore")
    _add_restore_args(p)
    args = p.parse_args(argv)
    images = sorted(sum([glob.glob(os.path.join(args.img_dir, e))
                         for e in ("*.png", "*.jpg", "*.jpeg")], []))
    _refuse_unserved(args, images)

    pipe = load_checkpointed_pipeline(args)
    if args.negative_prompt:
        print("WARNING: --negative_prompt ignored (no text-encoder "
              "checkpoint); using zero negative embeds")
    os.makedirs(args.save_dir, exist_ok=True)
    cross_dim = pipe.unet.config.cross_attention_dim
    pooled_dim = (pipe.unet.config.projection_class_embeddings_input_dim
                  - 6 * pipe.unet.config.addition_time_embed_dim)
    prompt_embeds = torch.zeros((1, 77, cross_dim))
    pooled = torch.zeros((1, pooled_dim))
    for path in images:
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.save_dir, f"{name}.png")
        if os.path.exists(out_path):
            print(f"skip {name}")
            continue
        t0 = time.perf_counter()
        img = read_png(path)
        if args.json_dir:
            jpath = os.path.join(args.json_dir, f"{name}.json")
            if os.path.exists(jpath):
                with open(jpath) as f:
                    caption = trim_caption(json.load(f)["caption"])
                print(f"caption of {name} not used: {_TEXT_TOWERS}: "
                      f"{caption!r}")
        t1 = time.perf_counter()
        if args.hdr > 0:
            img = create_hdr_effect(img, args.hdr, device=args.device)
        t2 = time.perf_counter()
        h, w = img.shape[:2]
        img = resize_lanczos(img, (w * args.upscale, h * args.upscale))
        padded, w0, h0, _, _ = check_image_size(img)
        t3 = time.perf_counter()
        out = pipe(padded, prompt_embeds, pooled, seed=args.seed,
                   output_type="uint8")
        t4 = time.perf_counter()
        write_png(out_path, out[:h0, :w0])
        t5 = time.perf_counter()
        print(f"restored {name} -> {out_path}: read_s={t1 - t0:.4f} "
              f"hdr_s={t2 - t1:.4f} resize_s={t3 - t2:.4f} "
              f"pipeline_s={t4 - t3:.4f} write_s={t5 - t4:.4f}")
    return 0


def _not_yet(command: str):
    def run(argv):
        raise NotImplementedError(f"{command}: {_NOT_YET[command]}")
    return run


COMMANDS = {"restore": cmd_restore,
            **{name: _not_yet(name) for name in _NOT_YET}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m faithdiff_tpu_torch.cli "
              f"{{{'|'.join(COMMANDS)}}} ...")
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
