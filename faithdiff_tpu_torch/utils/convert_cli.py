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

  python -m faithdiff_tpu_torch.utils.convert_cli export \\
      --checkpoint_dir ckpts/ --out FaithDiff.bin

writes the converted UNet and denoise encoder back in FaithDiff.bin's
layout.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict

import torch

from .convert import (TEXT_TOWERS, clip_text_state_dict_from_reference,
                      denoise_encoder_state_dict_from_reference,
                      export_faithdiff_bin, load_torch_bin,
                      unet_state_dict_from_reference)
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


def _save(state_dict: Dict[str, torch.Tensor], out_dir: str, name: str) -> None:
    os.makedirs(os.path.join(out_dir, name), exist_ok=True)
    save_file(state_dict, os.path.join(out_dir, name, MODEL_FILE),
              metadata={"format": "pt"})


def main(argv=None) -> int:
    p = argparse.ArgumentParser("convert")
    p.add_argument("--sdxl_dir", required=True,
                   help="diffusers SDXL repo dir (unet/, text_encoder*/)")
    p.add_argument("--faithdiff_bin", default=None)
    p.add_argument("--vae_dir", default=None)
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
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
    print(f"converted checkpoints -> {args.out_dir}")
    return 0


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
