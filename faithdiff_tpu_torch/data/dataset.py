"""Offline paired super-resolution training dataset (counterpart of
`faithdiff_tpu/data/dataset.py`; the reference's `LocalImageDataset`).

Nature and face HR/LR/caption triplets: caption trimming, hflip, a paired
random crop (HR `resolution`, LR `resolution / scale`), the LR
re-upscaled by an interpolation drawn from NEAREST / BILINEAR / BICUBIC,
[-1, 1] normalisation, caption dropout and SDXL micro-conditioning
(original size, crop offset, target size). PNGs and JPEGs are read by
`utils/png.read_rgb` (as Pillow's `convert("RGB")` reads them) and resized by the port's Pillow-exact resamplers,
so each draw of a `random.Random(seed)` gives the JAX dataset's sample
bit for bit. Host-side numpy.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..training.text_embeds import trim_caption
from ..utils.png import read_rgb
from ..utils.resample import resize_bicubic, resize_bilinear, resize_nearest

__all__ = ["trim_caption", "read_image", "paired_random_crop", "PairedSample",
           "LocalPairedDataset", "collate", "discover_pairs"]


def paired_random_crop(
    hr: np.ndarray, lr: np.ndarray, hr_size: int, scale: int,
    rng: random.Random,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Aligned crops: LR of hr_size/scale, HR of hr_size at the matching
    place. Returns (hr, lr, (top, left)), the HR crop offset."""
    lr_size = hr_size // scale
    lh, lw = lr.shape[:2]
    if lh < lr_size or lw < lr_size:
        raise ValueError(f"LR image {lh}x{lw} smaller than crop {lr_size}")
    top = rng.randint(0, lh - lr_size)
    left = rng.randint(0, lw - lr_size)
    lr_crop = lr[top:top + lr_size, left:left + lr_size]
    hr_crop = hr[top * scale:top * scale + hr_size,
                 left * scale:left * scale + hr_size]
    return hr_crop, lr_crop, (top * scale, left * scale)


# PIL's NEAREST, BILINEAR, BICUBIC, in the order the JAX dataset draws them
_RESAMPLE = [resize_nearest, resize_bilinear, resize_bicubic]


@dataclasses.dataclass
class PairedSample:
    hr: np.ndarray             # [H, W, 3] float32 in [-1, 1]
    lq: np.ndarray             # [H, W, 3] float32 in [-1, 1] (re-upscaled)
    caption: str
    original_size: Tuple[int, int]
    crop_coords: Tuple[int, int]
    target_size: Tuple[int, int]


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a PNG or a JPEG."""
    return read_rgb(path)


class LocalPairedDataset:
    """Directory-backed paired dataset over parallel lists `hr_paths[i]`,
    `lr_paths[i]`, `caption_paths[i]` (plain-text captions). Face sources
    get the FFHQ-style random LR resize to 128-192 px first."""

    def __init__(
        self,
        hr_paths: Sequence[str],
        lr_paths: Sequence[str],
        caption_paths: Optional[Sequence[str]] = None,
        is_face: Optional[Sequence[bool]] = None,
        resolution: int = 512,
        scale: int = 4,
        hflip: bool = True,
        caption_dropout: float = 0.2,
        seed: int = 0,
    ):
        assert len(hr_paths) == len(lr_paths)
        self.hr_paths = list(hr_paths)
        self.lr_paths = list(lr_paths)
        self.caption_paths = list(caption_paths) if caption_paths else None
        self.is_face = list(is_face) if is_face else [False] * len(hr_paths)
        self.resolution = resolution
        self.scale = scale
        self.hflip = hflip
        self.caption_dropout = caption_dropout
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.hr_paths)

    def _load_caption(self, idx: int) -> str:
        if self.caption_paths is None:
            return ""
        with open(self.caption_paths[idx]) as f:
            text = f.read().strip()
        return trim_caption(text)

    def __getitem__(self, idx: int, rng=None) -> PairedSample:
        hr = read_image(self.hr_paths[idx])
        lr = read_image(self.lr_paths[idx])
        caption = self._load_caption(idx)
        return self.prepare(hr, lr, caption, self.is_face[idx], rng=rng)

    def prepare(self, hr: np.ndarray, lr: np.ndarray, caption: str,
                face: bool = False, rng=None) -> PairedSample:
        # an explicit rng makes a draw independent of call order (the
        # parallel loader derives one per draw)
        rng = rng if rng is not None else self.rng
        size = self.resolution
        scale = self.scale

        if face:
            # FFHQ: a random 128-192 LR resize, the HR following at scale x
            lr_size = rng.randint(128, 192)
            lr = resize_bicubic(lr, (lr_size, lr_size))
            hr = resize_bicubic(hr, (lr_size * scale, lr_size * scale))

        original_size = (hr.shape[0], hr.shape[1])

        if self.hflip and rng.random() < 0.5:
            hr = hr[:, ::-1]
            lr = lr[:, ::-1]

        # pad small images so the crop fits
        lr_min = size // scale
        if lr.shape[0] < lr_min or lr.shape[1] < lr_min:
            ph = max(lr_min - lr.shape[0], 0)
            pw = max(lr_min - lr.shape[1], 0)
            lr = np.pad(lr, ((0, ph), (0, pw), (0, 0)), mode="edge")
            hr = np.pad(hr, ((0, ph * scale), (0, pw * scale), (0, 0)),
                        mode="edge")

        hr, lr, crop_coords = paired_random_crop(hr, lr, size, scale, rng)

        # the LR re-upscaled by a random interpolation
        method = rng.choice(_RESAMPLE)
        lq = method(np.ascontiguousarray(lr), (size, size))

        hr_f = hr.astype(np.float32) / 127.5 - 1.0
        lq_f = lq.astype(np.float32) / 127.5 - 1.0

        if rng.random() < self.caption_dropout:
            caption = ""

        return PairedSample(
            hr=hr_f, lq=lq_f, caption=caption,
            original_size=original_size, crop_coords=crop_coords,
            target_size=(size, size),
        )


def collate(samples: Sequence[PairedSample]) -> Dict[str, np.ndarray]:
    """Stack samples into a batch; micro-conditioning as the [orig, crop,
    target] 6-vector the UNet takes."""
    return {
        "hr": np.stack([s.hr for s in samples]),
        "lq": np.stack([s.lq for s in samples]),
        "captions": [s.caption for s in samples],
        "add_time_ids": np.asarray(
            [[*s.original_size, *s.crop_coords, *s.target_size]
             for s in samples], np.float32),
    }


def discover_pairs(
    hr_dir: str, lr_dir: str, caption_dir: Optional[str] = None,
    exts: Tuple[str, ...] = (".png", ".jpg", ".jpeg"),
) -> Tuple[List[str], List[str], Optional[List[str]]]:
    """Match HR / LR (/ caption) files by stem."""
    def stems(d):
        out = {}
        for p in sorted(glob.glob(os.path.join(d, "*"))):
            stem, ext = os.path.splitext(os.path.basename(p))
            if ext.lower() in exts or ext.lower() == ".txt":
                out[stem] = p
        return out

    hr = stems(hr_dir)
    lr = stems(lr_dir)
    caps = stems(caption_dir) if caption_dir else None
    keys = sorted(set(hr) & set(lr) & (set(caps) if caps else set(hr)))
    return ([hr[k] for k in keys], [lr[k] for k in keys],
            [caps[k] for k in keys] if caps else None)
