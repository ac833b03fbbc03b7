"""MANIQA (Yang et al. 2022, Multi-dimension Attention Network; counterpart
of `faithdiff_tpu/eval/maniqa.py`).

- a ViT patch-8 backbone; token features from four intermediate blocks
  are channel-concatenated (the paper taps blocks 6-9 of ViT-B/8);
- stage 1: transposed attention blocks (TAB: attention across the
  *channel* axis), 1x1 conv 4D -> D, then a Swin stage (window attention
  with relative position bias, alternating cyclic shift) with 0.8-scaled
  residuals;
- stage 2: the same with D -> D/2;
- dual heads: per-token quality and weight branches, score =
  sum(score * weight) / sum(weight).

`MANIQAConfig` defaults to ViT-B/8 at 224 as published. Attention is plain
torch (einsum softmax), as it is XLA in the JAX package. Weights-gated:
`make_maniqa` returns None without the JAX harness's npz (`convert_maniqa`
+ `save_maniqa_weights`). It averages a deterministic 5-crop (four
corners + centre) instead of the paper's random crops, as in JAX; an image
below 224 is first enlarged with Pillow's BICUBIC
(`utils/resample.resize_bicubic`).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import LayerNorm
from ..utils.resample import resize_bicubic
from .lpips import (_to_numpy, config_from_blob, load_lpips_params, load_tree_,
                    network, resolve_device, save_lpips_params)


@dataclasses.dataclass(frozen=True)
class MANIQAConfig:
    img_size: int = 224
    patch_size: int = 8
    vit_embed: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    feature_blocks: Tuple[int, ...] = (6, 7, 8, 9)
    embed_dim: int = 768          # stage-1 width (conv1 output)
    num_tab: int = 2              # TAB blocks per stage
    swin_depths: Tuple[int, ...] = (2, 2)
    swin_heads: Tuple[int, ...] = (4, 4)
    window_size: int = 4
    dim_mlp: int = 768
    scale: float = 0.8            # swin residual scale
    norm_mean: float = 0.5
    norm_std: float = 0.5
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def _softmax_attention(q, k, v):
    """[B, S, H, hd] q, k, v -> [B, S, H, hd]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(dim=-1), v)


# ---------------------------------------------------------------------------
# ViT backbone (timm vit_*_patch8 layout)
# ---------------------------------------------------------------------------

class _ViTBlock(nn.Module):
    def __init__(self, cfg: MANIQAConfig):
        super().__init__()
        d = cfg.vit_embed
        self.heads = cfg.vit_heads
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.vit_mlp)
        self.fc2 = nn.Linear(cfg.vit_mlp, d)

    def forward(self, x):
        b, s, d = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, s, 3, self.heads, d // self.heads)
        o = _softmax_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.proj(o.reshape(b, s, d))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class ViTBackbone(nn.Module):
    def __init__(self, cfg: MANIQAConfig):
        super().__init__()
        d, p = cfg.vit_embed, cfg.patch_size
        self.patch_proj = nn.Conv2d(3, d, p, p)
        self.cls = nn.Parameter(torch.zeros(d))
        self.pos = nn.Parameter(torch.zeros(cfg.grid ** 2 + 1, d))
        for i in range(cfg.vit_layers):
            self.add_module(f"block{i}", _ViTBlock(cfg))
        self.n_layers = cfg.vit_layers

    def forward(self, x) -> List[torch.Tensor]:
        """x: [B, H, W, 3] normalised. Returns per-block token features
        (cls dropped), each [B, N, D]."""
        x = self.patch_proj(x.permute(0, 3, 1, 2))          # [B, D, gh, gw]
        b, d = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls.expand(b, 1, d), x], dim=1) + self.pos[None]
        taps = []
        for i in range(self.n_layers):
            x = getattr(self, f"block{i}")(x)
            taps.append(x[:, 1:])
        return taps


# ---------------------------------------------------------------------------
# TAB: attention transposed to the channel axis
# ---------------------------------------------------------------------------

class TABlock(nn.Module):
    """x: [B, C, N]; q/k/v are linear over N, attention is [C, C]."""

    def __init__(self, n: int):
        super().__init__()
        self.c_q, self.c_k, self.c_v = (nn.Linear(n, n) for _ in range(3))

    def forward(self, x):
        n = x.shape[-1]
        q, k, v = self.c_q(x), self.c_k(x), self.c_v(x)
        attn = (torch.einsum("bcn,bdn->bcd", q, k) / math.sqrt(n)).softmax(dim=-1)
        return torch.einsum("bcd,bdn->bcn", attn, v) + x


# ---------------------------------------------------------------------------
# Swin stage (window attention, relative position bias, cyclic shift)
# ---------------------------------------------------------------------------

def _rel_pos_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # [2, w², w²]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """Swin SW-MSA mask: [num_windows, w², w²], 0 allowed / -1e9 blocked."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = np.roll(img, (-shift, -shift), (0, 1))
    wins = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, win * win)
    mask = (wins[:, :, None] != wins[:, None, :]) * -1e9
    return mask.astype(np.float32)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 dim_mlp: int, scale: float, eps: float = 1e-6):
        super().__init__()
        self.heads, self.window, self.shift, self.scale = heads, window, shift, scale
        self.norm1 = LayerNorm(dim, eps)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps)
        self.fc1 = nn.Linear(dim, dim_mlp)
        self.fc2 = nn.Linear(dim_mlp, dim)

    def forward(self, x, hw: Tuple[int, int]):
        h, w = hw
        win, shift = self.window, self.shift
        b, n, c = x.shape
        res = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        nh, nw = h // win, w // win
        xw = x.reshape(b, nh, win, nw, win, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nh * nw, win * win, c)

        hd = c // self.heads
        qkv = self.qkv(xw).reshape(-1, win * win, 3, self.heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        idx = torch.as_tensor(_rel_pos_index(win), device=x.device)
        logits = logits + self.rel_bias[idx].permute(2, 0, 1)[None]
        if shift > 0:
            mask = torch.as_tensor(_shift_mask(h, w, win, shift), device=x.device)
            logits = (logits.reshape(b, nh * nw, self.heads, win * win, win * win)
                      + mask[None, :, None]).reshape(
                          b * nh * nw, self.heads, win * win, win * win)
        o = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(dim=-1), v)
        o = self.proj(o.reshape(-1, win * win, c))
        o = o.reshape(b, nh, nw, win, win, c).permute(0, 1, 3, 2, 4, 5)
        o = o.reshape(b, h, w, c)
        if shift > 0:
            o = torch.roll(o, (shift, shift), (1, 2))
        x = res + self.scale * o.reshape(b, n, c)
        hmid = F.gelu(self.fc1(self.norm2(x)))
        return x + self.scale * self.fc2(hmid)


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 dim_mlp: int, scale: float):
        super().__init__()
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(
                dim, heads, window, 0 if i % 2 == 0 else window // 2,
                dim_mlp, scale))
        self.depth = depth

    def forward(self, x, hw):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, hw)
        return x


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _conv1x1(conv: nn.Conv2d, y: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv over channel-last tokens [B, N, C]."""
    return F.linear(y, conv.weight[:, :, 0, 0], conv.bias)


class MANIQA(nn.Module):
    def __init__(self, cfg: MANIQAConfig = MANIQAConfig()):
        super().__init__()
        self.cfg = cfg
        n = cfg.grid ** 2
        d1, d2 = cfg.embed_dim, cfg.embed_dim // 2
        self.vit = ViTBackbone(cfg)
        for stage in (1, 2):
            for i in range(cfg.num_tab):
                self.add_module(f"tab{stage}_{i}", TABlock(n))
        self.conv1 = nn.Conv2d(cfg.vit_embed * len(cfg.feature_blocks), d1, 1)
        self.swin1 = SwinStage(d1, cfg.swin_depths[0], cfg.swin_heads[0],
                               cfg.window_size, cfg.dim_mlp, cfg.scale)
        self.conv2 = nn.Conv2d(d1, d2, 1)
        self.swin2 = SwinStage(d2, cfg.swin_depths[1], cfg.swin_heads[1],
                               cfg.window_size, cfg.dim_mlp, cfg.scale)
        self.score_fc1, self.score_fc2 = nn.Linear(d2, d2), nn.Linear(d2, 1)
        self.weight_fc1, self.weight_fc2 = nn.Linear(d2, d2), nn.Linear(d2, 1)

    def _tabs(self, stage: int, y: torch.Tensor) -> torch.Tensor:
        y = y.transpose(1, 2)                               # [B, C, N]
        for i in range(self.cfg.num_tab):
            y = getattr(self, f"tab{stage}_{i}")(y)
        return y.transpose(1, 2)

    def forward(self, x):
        """x: [B, S, S, 3] in [0, 1] (S = cfg.img_size). Returns [B]."""
        cfg = self.cfg
        g = cfg.grid
        x = (x - cfg.norm_mean) / cfg.norm_std
        taps = self.vit(x)
        y = torch.cat([taps[i] for i in cfg.feature_blocks], dim=-1)  # [B, N, 4D]
        y = self.swin1(_conv1x1(self.conv1, self._tabs(1, y)), (g, g))
        y = self.swin2(_conv1x1(self.conv2, self._tabs(2, y)), (g, g))
        s = F.relu(self.score_fc2(F.relu(self.score_fc1(y))))[..., 0]   # [B, N]
        w = torch.sigmoid(self.weight_fc2(F.relu(self.weight_fc1(y))))[..., 0]
        return (s * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1e-8)


# ---------------------------------------------------------------------------
# converter + factory
# ---------------------------------------------------------------------------

def convert_maniqa(state_dict: Dict, cfg: MANIQAConfig = MANIQAConfig()) -> Dict:
    """Official torch layout -> the flax tree. `vit.*` follows timm ViT
    naming (`blocks.N.attn.qkv` fused, `mlp.fc1/2`), the rest the MANIQA
    module names (`tablock{1,2}.N.c_{q,k,v}`, `conv{1,2}`,
    `swintransformer{1,2}.layers.N....`, `fc_score.*`, `fc_weight.*`)."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}

    def dense(key):
        return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}

    def norm(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    vit: Dict = {
        "patch_proj": {"kernel": sd["vit.patch_embed.proj.weight"].transpose(2, 3, 1, 0),
                       "bias": sd["vit.patch_embed.proj.bias"]},
        "cls": sd["vit.cls_token"].reshape(-1),
        "pos": sd["vit.pos_embed"].reshape(-1, sd["vit.pos_embed"].shape[-1]),
    }
    for i in range(cfg.vit_layers):
        p = f"vit.blocks.{i}"
        vit[f"block{i}"] = {
            "norm1": norm(f"{p}.norm1"), "norm2": norm(f"{p}.norm2"),
            "qkv": dense(f"{p}.attn.qkv"), "proj": dense(f"{p}.attn.proj"),
            "fc1": dense(f"{p}.mlp.fc1"), "fc2": dense(f"{p}.mlp.fc2"),
        }
    params: Dict = {"vit": vit}
    for stage in (1, 2):
        for i in range(cfg.num_tab):
            p = f"tablock{stage}.{i}"
            params[f"tab{stage}_{i}"] = {nm: dense(f"{p}.{nm}")
                                         for nm in ("c_q", "c_k", "c_v")}
        params[f"conv{stage}"] = {
            "kernel": sd[f"conv{stage}.weight"].transpose(2, 3, 1, 0),
            "bias": sd[f"conv{stage}.bias"]}
        sw: Dict = {}
        for i in range(cfg.swin_depths[stage - 1]):
            p = f"swintransformer{stage}.layers.{i}"
            sw[f"block{i}"] = {
                "norm1": norm(f"{p}.norm1"), "norm2": norm(f"{p}.norm2"),
                "qkv": dense(f"{p}.attn.qkv"), "proj": dense(f"{p}.attn.proj"),
                "fc1": dense(f"{p}.mlp.fc1"), "fc2": dense(f"{p}.mlp.fc2"),
                "rel_bias": sd[f"{p}.attn.relative_position_bias_table"],
            }
        params[f"swin{stage}"] = sw

    # fc_score / fc_weight: Sequential(Linear, ReLU, Linear, act)
    def lin(head):
        return sorted(int(k.split(".")[1]) for k in sd
                      if k.startswith(f"{head}.") and k.endswith(".weight"))

    for head, ours in (("fc_score", "score"), ("fc_weight", "weight")):
        i0, i1 = lin(head)[:2]
        params[f"{ours}_fc1"] = dense(f"{head}.{i0}")
        params[f"{ours}_fc2"] = dense(f"{head}.{i1}")
    return params


_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "maniqa.npz")


def build_maniqa(tree: Mapping, cfg: MANIQAConfig, device="cuda") -> MANIQA:
    device = resolve_device(device, "MANIQA")
    return load_tree_(MANIQA(cfg), tree).to(device).eval()


def five_crops(img: np.ndarray, s: int) -> np.ndarray:
    """[H, W, 3] in [0, 1] -> [5, s, s, 3]: the four corners and the centre,
    after a Pillow BICUBIC enlargement of a side below `s`."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    if h < s or w < s:
        img = resize_bicubic(np.uint8(np.clip(img, 0, 1) * 255),
                             (max(w, s), max(h, s))).astype(np.float32) / 255.0
        h, w = img.shape[:2]
    return np.stack([img[y:y + s, x:x + s]
                     for y, x in ((0, 0), (0, w - s), (h - s, 0), (h - s, w - s),
                                  ((h - s) // 2, (w - s) // 2))]).astype(np.float32)


def make_maniqa(weights_path: Optional[str] = None,
                cfg: Optional[MANIQAConfig] = None, device="cuda"):
    """MANIQA callable `(img [H, W, 3] in [0,1]) -> float` on `device`
    (deterministic 5-crop mean), or None when no converted weights exist;
    `prepare` and `net` are its halves."""
    device = resolve_device(device, "MANIQA")
    path = weights_path or _DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    tree = load_lpips_params(path)
    blob = tree.pop("_config", None)
    if cfg is None:
        cfg = config_from_blob(MANIQAConfig, blob) if blob is not None else MANIQAConfig()
    run = network(build_maniqa(tree, cfg, device))

    def prepare(img: np.ndarray):
        return (torch.as_tensor(five_crops(img, cfg.img_size), device=device),)

    def call(img: np.ndarray) -> float:
        return float(run(*prepare(img)).mean())

    call.prepare, call.net = prepare, run
    return call


def save_maniqa_weights(params: Dict, path: str,
                        cfg: Optional[MANIQAConfig] = None) -> None:
    """Write a self-contained MANIQA npz (params + config JSON)."""
    extra: Dict = {}
    if cfg is not None:
        extra["_config"] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
    save_lpips_params({**params, **extra}, path)
