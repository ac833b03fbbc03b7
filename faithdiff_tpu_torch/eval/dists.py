"""DISTS (Deep Image Structure and Texture Similarity, Ding et al. 2020;
counterpart of `faithdiff_tpu/eval/dists.py`).

A VGG16 backbone with L2 pooling instead of max pooling, and per-stage /
channel texture (mean) and structure (covariance) similarities weighted
by learned alpha / beta. Weights-gated: `make_dists` needs a converted
checkpoint (`dists.npz` from `convert_dists`, the JAX harness's file) or
returns None and the harness reports UNAVAILABLE.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .lpips import (_to_numpy, load_lpips_params, load_tree_, network,
                    resolve_device)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
STAGE_CHANNELS = (3, 64, 128, 256, 512, 512)


def _hann2d(size: int = 3) -> np.ndarray:
    a = np.hanning(size + 2)[1:-1]
    w = np.outer(a, a)
    return (w / w.sum()).astype(np.float32)


def l2_pool(x: torch.Tensor, size: int = 3, stride: int = 2) -> torch.Tensor:
    """sqrt(hann-weighted average of squares), the DISTS downsampler, over
    NCHW: a depthwise conv of x^2, stride 2, zero padding 1."""
    c = x.shape[1]
    k = torch.as_tensor(_hann2d(size), device=x.device, dtype=x.dtype)
    y = F.conv2d(x.square(), k.expand(c, 1, size, size), stride=stride,
                 padding=1, groups=c)
    return torch.sqrt(torch.clamp(y, min=1e-12))


class VGG16L2Pool(nn.Module):
    """VGG16 feature taps with L2 pooling between stages; tap 0 is the
    (ImageNet-normalised) input itself. NCHW."""

    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for ch, n_convs in _VGG_STAGES:
            for _ in range(n_convs):
                self.add_module(f"conv{idx}", nn.Conv2d(cin, ch, 3, 1, 1))
                cin, idx = ch, idx + 1
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        x = (x - self.mean) / self.std
        taps, idx = [x], 0
        for stage, (_, n_convs) in enumerate(_VGG_STAGES):
            if stage > 0:
                x = l2_pool(x)
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            taps.append(x)
        return taps


class DISTS(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = VGG16L2Pool()
        for i, c in enumerate(STAGE_CHANNELS):
            setattr(self, f"alpha{i}", nn.Parameter(torch.ones(c)))
        for i, c in enumerate(STAGE_CHANNELS):
            setattr(self, f"beta{i}", nn.Parameter(torch.ones(c)))

    def forward(self, a, b):
        """a, b: [B, H, W, 3] in [0, 1]. Returns [B] distances (lower =
        more similar)."""
        fa = self.backbone(a.permute(0, 3, 1, 2))
        fb = self.backbone(b.permute(0, 3, 1, 2))
        c1 = c2 = 1e-6
        alpha = [getattr(self, f"alpha{i}") for i in range(len(STAGE_CHANNELS))]
        beta = [getattr(self, f"beta{i}") for i in range(len(STAGE_CHANNELS))]
        w_sum = sum(a_.sum() for a_ in alpha) + sum(b_.sum() for b_ in beta)
        score = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            mu_a = xa.mean(dim=(2, 3))                      # [B, C]
            mu_b = xb.mean(dim=(2, 3))
            var_a = xa.square().mean(dim=(2, 3)) - mu_a.square()
            var_b = xb.square().mean(dim=(2, 3)) - mu_b.square()
            cov = (xa * xb).mean(dim=(2, 3)) - mu_a * mu_b
            texture = (2 * mu_a * mu_b + c1) / (mu_a.square() + mu_b.square() + c1)
            structure = (2 * cov + c2) / (var_a + var_b + c2)
            score = score + (alpha[i][None] * texture
                             + beta[i][None] * structure).sum(dim=-1)
        return 1.0 - score / w_sum


def convert_dists(state_dict: Dict) -> Dict:
    """DISTS torch checkpoint -> the flax tree. Keys: `stage1.0.weight`-style
    VGG convs (or `features.N.weight`), plus `alpha`/`beta` [1, sum(C), 1, 1]."""
    convs = {}
    conv_keys = [k for k in state_dict
                 if k.endswith(".weight") and _to_numpy(state_dict[k]).ndim == 4]

    def order(k):
        parts = k.split(".")
        nums = [int(p) for p in parts if p.isdigit()]
        stage = (int(parts[0].replace("stage", ""))
                 if parts[0].startswith("stage") else 0)
        return (stage, nums)

    for i, k in enumerate(sorted(conv_keys, key=order)):
        w = _to_numpy(state_dict[k])
        b = _to_numpy(state_dict[k[:-len("weight")] + "bias"])
        convs[f"conv{i}"] = {"kernel": w.transpose(2, 3, 1, 0), "bias": b}
    assert len(convs) == 13, f"expected 13 VGG convs, got {len(convs)}"
    params: Dict = {"backbone": convs}
    alpha = _to_numpy(state_dict["alpha"]).reshape(-1)
    beta = _to_numpy(state_dict["beta"]).reshape(-1)
    off = 0
    for i, c in enumerate(STAGE_CHANNELS):
        params[f"alpha{i}"] = alpha[off:off + c]
        params[f"beta{i}"] = beta[off:off + c]
        off += c
    assert off == alpha.size == beta.size
    return params


_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "dists.npz")


def build_dists(tree: Mapping, device="cuda") -> DISTS:
    device = resolve_device(device, "DISTS")
    return load_tree_(DISTS(), tree).to(device).eval()


def make_dists(weights_path: Optional[str] = None, device="cuda"):
    """DISTS callable `(img, ref in [0,1]) -> float` on `device`, or None
    when no weights exist; `prepare` and `net` are its halves."""
    device = resolve_device(device, "DISTS")
    path = weights_path or _DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    run = network(build_dists(load_lpips_params(path), device))

    def prepare(img: np.ndarray, ref: np.ndarray):
        if img.ndim == 3:
            img, ref = img[None], ref[None]
        return (torch.as_tensor(np.asarray(img, np.float32), device=device),
                torch.as_tensor(np.asarray(ref, np.float32), device=device))

    def call(img: np.ndarray, ref: np.ndarray) -> float:
        return float(run(*prepare(img, ref))[0])

    call.prepare, call.net = prepare, run
    return call
