"""Checkpoint conversion CLI (counterpart of
`faithdiff_tpu/utils/convert_cli.py`).

Reads the reference's torch checkpoints and writes the port's state dicts
as safetensors files, one directory a model:

  python -m faithdiff_tpu_torch.utils.convert_cli \\
      --sdxl_dir /path/RealVisXL_V4.0 \\
      --faithdiff_bin /path/FaithDiff.bin \\
      --vae_dir /path/sdxl-vae-fp16-fix \\
      --out_dir ckpts/

writes ckpts/{unet,vae,denoise_encoder}/model.safetensors and, from the
SDXL dir's `text_encoder/` and `text_encoder_2/`,
ckpts/text_encoders/model.safetensors (both towers, each under its
directory's name: the state dict of `models.clip_text.SDXLTextEncoder`),
which `python -m faithdiff_tpu_torch.cli restore --checkpoint_dir ckpts/`
reads. Tensors keep the dtype they were read in (the models cast them as
they load them).

  python -m faithdiff_tpu_torch.utils.convert_cli \\
      --llava /path/llava-v1.5-13b \\
      --clip_vision /path/clip-vit-large-patch14-336/pytorch_model.bin \\
      --out_dir ckpts/

writes the captioner: ckpts/captioner/llama/ (one safetensors file per
shard of `--llava`, which is a file, a directory with a
`*.index.json`, or that index), captioner/projector/ (its
`model.mm_projector.*`), captioner/vision/ (the `vision_model.*` of the
CLIP file) and captioner/tokenizer/ (`tokenizer.model`,
`tokenizer_config.json`, `special_tokens_map.json` where the `--llava`
directory holds them), which `python -m faithdiff_tpu_torch.cli caption
--captioner_dir ckpts/captioner` reads. Each of these directories is
written anew (what an earlier conversion left there is removed). Shards are
converted one at a time
(`.bin` shards memory-mapped), so at most one is in host memory.

  python -m faithdiff_tpu_torch.utils.convert_cli export \\
      --checkpoint_dir ckpts/ --out FaithDiff.bin

writes the converted UNet and denoise encoder back in FaithDiff.bin's
layout.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
from typing import Dict, List, Tuple

import torch

from .convert import (TEXT_TOWERS, clip_text_state_dict_from_reference,
                      clip_vision_state_dict_from_reference,
                      denoise_encoder_state_dict_from_reference,
                      export_faithdiff_bin, llava_state_dicts_from_reference,
                      load_torch_bin, unet_state_dict_from_reference)
from .safetensors import load_file, save_file

MODEL_FILE = "model.safetensors"


def _load_any(path_or_dir: str, subfolder: str = "") -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` and `*.bin` under a directory (or one file),
    merged in sorted order."""
    base = os.path.join(path_or_dir, subfolder) if subfolder else path_or_dir
    if os.path.isfile(base):
        cands = [base]
    else:
        cands = (glob.glob(os.path.join(base, "*.safetensors"))
                 + glob.glob(os.path.join(base, "*.bin")))
    if not cands:
        raise FileNotFoundError(f"no checkpoint under {base}")
    merged: Dict[str, torch.Tensor] = {}
    for c in sorted(cands):
        merged.update(load_file(c) if c.endswith(".safetensors")
                      else load_torch_bin(c))
    return merged


def _save(state_dict: Dict[str, torch.Tensor], out_dir: str, name: str,
          file: str = MODEL_FILE) -> None:
    os.makedirs(os.path.join(out_dir, name), exist_ok=True)
    save_file(state_dict, os.path.join(out_dir, name, file),
              metadata={"format": "pt"})


def _load_one(path: str) -> Dict[str, torch.Tensor]:
    return load_file(path) if path.endswith(".safetensors") else load_torch_bin(path)


INDEX_FILES = ("pytorch_model.bin.index.json", "model.safetensors.index.json")
TOKENIZER_FILES = ("tokenizer.model", "tokenizer_config.json",
                   "special_tokens_map.json")


def llava_shards(path: str) -> Tuple[List[str], List[str]]:
    """(shard files in sorted order, keys the index names) of `--llava`:
    one file (no index), a `*.index.json`, or a directory holding one (as
    `scripts/prepare_checkpoint.py` takes it; a missing file's directory
    too)."""
    if not path.endswith(".index.json"):
        if os.path.isfile(path):
            return [path], []
        d = path if os.path.isdir(path) else os.path.dirname(path) or "."
        found = [os.path.join(d, f) for f in INDEX_FILES
                 if os.path.isfile(os.path.join(d, f))]
        if not found:
            raise FileNotFoundError(f"{path}: not a file, and no *.index.json "
                                    f"found in {d}")
        path = found[0]
    with open(path) as f:
        weight_map = json.load(f)["weight_map"]
    d = os.path.dirname(path) or "."
    return ([os.path.join(d, s) for s in sorted(set(weight_map.values()))],
            sorted(weight_map))


def _clear(cap: str, *names: str) -> None:
    """Remove captioner/<name>/ for each name: the loader merges every file
    of a directory, so a file left from an earlier conversion (another
    shard count) would be read with the new ones."""
    for name in names:
        shutil.rmtree(os.path.join(cap, name), ignore_errors=True)


def convert_llava(llava: str, out_dir: str) -> Dict[str, int]:
    """`--llava` -> captioner/llama/ (a file per shard), captioner/projector/
    and captioner/tokenizer/, each written anew; returns {name: tensors
    written}. Raises if a key the index names is in no shard."""
    shards, indexed = llava_shards(llava)
    cap = os.path.join(out_dir, "captioner")
    _clear(cap, "llama", "projector", "tokenizer")
    projector: Dict[str, torch.Tensor] = {}
    seen = set()
    n_llama = 0
    for i, shard in enumerate(shards):
        sd = _load_one(shard)
        seen.update(sd)
        llama, proj = llava_state_dicts_from_reference(sd)
        projector.update({k: v.clone() for k, v in proj.items()})
        if llama:
            _save(llama, cap, "llama", f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors")
        n_llama += len(llama)
        del sd, llama, proj
    missing = set(indexed) - seen
    if missing:
        raise KeyError(f"{llava}: {len(missing)} keys named in the index are "
                       f"absent from the shards, e.g. {sorted(missing)[:3]}")
    if not projector:
        raise KeyError(f"{llava}: no projector keys (model.mm_projector.*)")
    _save(projector, cap, "projector")
    src = llava if os.path.isdir(llava) else os.path.dirname(llava) or "."
    copied = [f for f in TOKENIZER_FILES if os.path.isfile(os.path.join(src, f))]
    if copied:
        os.makedirs(os.path.join(cap, "tokenizer"), exist_ok=True)
        for f in copied:
            shutil.copyfile(os.path.join(src, f), os.path.join(cap, "tokenizer", f))
    return {"llama": n_llama, "projector": len(projector), "tokenizer": len(copied)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("convert")
    p.add_argument("--sdxl_dir", default=None,
                   help="diffusers SDXL repo dir (unet/, text_encoder*/)")
    p.add_argument("--faithdiff_bin", default=None)
    p.add_argument("--vae_dir", default=None)
    p.add_argument("--llava", default=None,
                   help="released llava-v1.5 checkpoint: a file, a dir with "
                        "a *.index.json, or the index -> captioner/{llama,"
                        "projector,tokenizer}")
    p.add_argument("--clip_vision", default=None,
                   help="openai/clip-vit-large-patch14-336 state dict "
                        "(.bin or .safetensors) -> captioner/vision")
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    if not (args.sdxl_dir or args.llava or args.clip_vision):
        p.error("nothing to convert: give --sdxl_dir, --llava or --clip_vision")
    if (args.faithdiff_bin or args.vae_dir) and not args.sdxl_dir:
        p.error("--faithdiff_bin and --vae_dir need --sdxl_dir")

    os.makedirs(args.out_dir, exist_ok=True)
    if args.llava:
        written = convert_llava(args.llava, args.out_dir)
        print(f"captioner from {args.llava}: {written}")
    if args.clip_vision:
        vision = clip_vision_state_dict_from_reference(_load_any(args.clip_vision))
        _clear(os.path.join(args.out_dir, "captioner"), "vision")
        _save(vision, os.path.join(args.out_dir, "captioner"), "vision")
        print(f"captioner vision tower: {len(vision)} tensors")
    if args.sdxl_dir:
        convert_restore(args)
    print(f"converted checkpoints -> {args.out_dir}")
    return 0


def convert_restore(args) -> None:
    """The restore's models from `--sdxl_dir` (and `--faithdiff_bin`,
    `--vae_dir`)."""
    unet_sd = _load_any(args.sdxl_dir, "unet")
    if args.faithdiff_bin:
        fd_sd = _load_any(args.faithdiff_bin)
        _save(denoise_encoder_state_dict_from_reference(fd_sd), args.out_dir,
              "denoise_encoder")
        unet_sd = unet_state_dict_from_reference(unet_sd, fd_sd)
    _save(unet_sd, args.out_dir, "unet")
    if args.vae_dir:
        _save(_load_any(args.vae_dir), args.out_dir, "vae")

    towers = [t for t in TEXT_TOWERS
              if os.path.isdir(os.path.join(args.sdxl_dir, t))]
    if towers and len(towers) != len(TEXT_TOWERS):
        raise FileNotFoundError(f"{args.sdxl_dir}: has {towers[0]}/ but not "
                                "both text towers")
    if towers:
        _save({f"{t}.{k}": v for t in TEXT_TOWERS for k, v in
               clip_text_state_dict_from_reference(
                   _load_any(args.sdxl_dir, t)).items()},
              args.out_dir, "text_encoders")


def export_main(argv=None) -> int:
    """Converted checkpoints -> a FaithDiff.bin in the reference layout
    (core UNet, fusion modules, `denoise_encoder.*`)."""
    p = argparse.ArgumentParser("export")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--out", required=True, help="output .bin path")
    args = p.parse_args(argv)

    unet_sd = _load_any(args.checkpoint_dir, "unet")
    de_dir = os.path.join(args.checkpoint_dir, "denoise_encoder")
    de_sd = _load_any(de_dir) if os.path.isdir(de_dir) else None
    sd = export_faithdiff_bin(unet_sd, de_sd)
    torch.save({k: v.contiguous() for k, v in sd.items()}, args.out)
    print(f"exported {len(sd)} tensors -> {args.out}")
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["export"]:
        sys.exit(export_main(argv[1:]))
    sys.exit(main(argv))
