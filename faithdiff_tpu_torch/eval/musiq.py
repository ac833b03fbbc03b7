"""MUSIQ (Multi-scale Image Quality transformer, Ke et al. 2021;
counterpart of `faithdiff_tpu/eval/musiq.py`).

- multi-scale input: the native-resolution image plus aspect-ratio-
  preserving (ARP) resizes with longer side 384 and 224 (Pillow BILINEAR
  on the uint8 image, `utils/resample.resize_bilinear`);
- each scale is cut into a full 32x32 patch grid, every patch linearly
  projected to the transformer width;
- hash-based 2D spatial embeddings (HSE): a learned [G, G, D] table
  indexed by the patch's fractional grid position;
- learned per-scale embeddings (SCE) and a [CLS] token;
- a pre-norm ViT encoder over the concatenated multi-scale sequence with a
  key-side mask for padding; quality = linear head on CLS.

The token sequence is padded to a fixed `max_tokens` with an explicit
mask, as in JAX. The attention is plain torch (einsum softmax), as it is
XLA in the JAX package.

Weights-gated: `make_musiq` returns None without the JAX harness's npz
(`convert_musiq` + `save_musiq_weights`, the config JSON under `_config`).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import LayerNorm
from ..utils.resample import resize_bilinear
from .lpips import (_to_numpy, config_from_blob, load_lpips_params, load_tree_,
                    network, resolve_device, save_lpips_params)


@dataclasses.dataclass(frozen=True)
class MUSIQConfig:
    patch_size: int = 32
    hidden_size: int = 384
    num_layers: int = 14
    num_heads: int = 6
    mlp_dim: int = 1152
    grid_size: int = 10           # HSE hash-grid resolution G
    num_scales: int = 3           # native + len(scale_longer_sides)
    scale_longer_sides: Tuple[int, ...] = (384, 224)
    max_tokens: int = 512         # sequence cap (excl. CLS)
    layer_norm_eps: float = 1e-6


class _EncoderBlock(nn.Module):
    def __init__(self, cfg: MUSIQConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.q, self.k, self.v, self.out = (nn.Linear(d, d) for _ in range(4))
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, d)

    def forward(self, x, mask_bias):
        h = self.norm1(x)
        b, s, d = h.shape
        hd = d // self.heads
        q = self.q(h).reshape(b, s, self.heads, hd)
        k = self.k(h).reshape(b, s, self.heads, hd)
        v = self.v(h).reshape(b, s, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        logits = logits + mask_bias[:, None, None, :]     # mask keys
        o = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(dim=-1), v)
        x = x + self.out(o.reshape(b, s, d))
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + h


class MUSIQ(nn.Module):
    def __init__(self, cfg: MUSIQConfig = MUSIQConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_proj = nn.Linear(cfg.patch_size ** 2 * 3, d)
        self.hse = nn.Parameter(torch.zeros(cfg.grid_size, cfg.grid_size, d))
        self.sce = nn.Parameter(torch.zeros(cfg.num_scales, d))
        self.cls = nn.Parameter(torch.zeros(d))
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", _EncoderBlock(cfg))
        self.norm = LayerNorm(d, cfg.layer_norm_eps)
        self.head = nn.Linear(d, 1)

    def forward(self, patches, grid_pos, scale_ids, mask):
        """patches:   [B, N, P*P*3] pixel patches in [0, 1] (padded),
        grid_pos:  [B, N, 2] int HSE indices (row, col) in [0, G),
        scale_ids: [B, N] int scale index per token,
        mask:      [B, N] 1.0 for real tokens.
        Returns [B] quality scores."""
        b = patches.shape[0]
        d = self.cfg.hidden_size
        grid_pos, scale_ids = grid_pos.long(), scale_ids.long()
        x = self.patch_proj(patches * 2.0 - 1.0)           # [0,1] -> [-1,1]
        x = x + self.hse[grid_pos[..., 0], grid_pos[..., 1]]
        x = x + self.sce[scale_ids]
        x = x * mask[..., None]
        x = torch.cat([self.cls.expand(b, 1, d), x], dim=1)
        full_mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        bias = torch.where(full_mask > 0, 0.0, -1e9).to(x.dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block{i}")(x, bias)
        return self.head(self.norm(x)[:, 0])[:, 0]


# ---------------------------------------------------------------------------
# host-side multi-scale tokenization
# ---------------------------------------------------------------------------

def _arp_resize(img: np.ndarray, longer_side: int) -> np.ndarray:
    h, w = img.shape[:2]
    s = longer_side / max(h, w)
    nh, nw = max(1, round(h * s)), max(1, round(w * s))
    return resize_bilinear(np.uint8(np.clip(img, 0, 1) * 255),
                           (nw, nh)).astype(np.float32) / 255.0


def _patchify(img: np.ndarray, cfg: MUSIQConfig,
              scale_id: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full patch grid of one scale -> (patches [N, P*P*3], grid_pos
    [N, 2], scale_ids [N]). HSE index: floor(i * G / n_rows)."""
    p = cfg.patch_size
    h, w = img.shape[:2]
    ph, pw = -(-h // p), -(-w // p)                        # ceil-div
    pad = np.zeros((ph * p, pw * p, 3), np.float32)
    pad[:h, :w] = img
    patches = pad.reshape(ph, p, pw, p, 3).transpose(0, 2, 1, 3, 4)
    patches = patches.reshape(ph * pw, p * p * 3)
    rows, cols = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
    grid = np.stack([
        np.floor(rows.reshape(-1) * cfg.grid_size / ph),
        np.floor(cols.reshape(-1) * cfg.grid_size / pw)], -1).astype(np.int32)
    return patches, grid, np.full((ph * pw,), scale_id, np.int32)


def tokenize_multiscale(img: np.ndarray, cfg: MUSIQConfig
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """img: [H, W, 3] float in [0, 1] -> fixed-shape token arrays
    (patches [1, N, P*P*3], grid_pos, scale_ids, mask), N = cfg.max_tokens.

    The native scale is centrally cropped to at most `max_tokens` minus the
    fixed-size resized scales' budget, preferring full coverage."""
    budget = cfg.max_tokens
    resized = [_arp_resize(img, s) for s in cfg.scale_longer_sides]
    fixed = sum((-(-r.shape[0] // cfg.patch_size))
                * (-(-r.shape[1] // cfg.patch_size)) for r in resized)
    native_budget = budget - fixed
    if native_budget <= 0:
        raise ValueError(
            f"max_tokens={cfg.max_tokens} below the resized-scale budget "
            f"{fixed}")
    p = cfg.patch_size
    h, w = img.shape[:2]
    ph, pw = -(-h // p), -(-w // p)
    if ph * pw > native_budget:
        # centre-crop the native scale down to the token budget, keeping
        # the aspect ratio (MUSIQ caps the native sequence the same way)
        ratio = np.sqrt(native_budget / (ph * pw))
        nph, npw = max(1, int(ph * ratio)), max(1, int(pw * ratio))
        while nph * npw > native_budget:
            if nph >= npw:
                nph -= 1
            else:
                npw -= 1
        y0 = (ph - nph) // 2 * p
        x0 = (pw - npw) // 2 * p
        native = img[y0:y0 + nph * p, x0:x0 + npw * p]
    else:
        native = img
    parts = [_patchify(native, cfg, 0)]
    parts += [_patchify(r, cfg, 1 + i) for i, r in enumerate(resized)]
    patches = np.concatenate([q[0] for q in parts])
    grid = np.concatenate([q[1] for q in parts])
    sid = np.concatenate([q[2] for q in parts])
    n = patches.shape[0]
    assert n <= cfg.max_tokens, (n, cfg.max_tokens)
    pad = cfg.max_tokens - n
    patches = np.pad(patches, ((0, pad), (0, 0)))
    grid = np.pad(grid, ((0, pad), (0, 0)))
    sid = np.pad(sid, (0, pad))
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return patches[None], grid[None], sid[None], mask[None]


# ---------------------------------------------------------------------------
# converter + factory
# ---------------------------------------------------------------------------

def convert_musiq(state_dict: Dict, cfg: MUSIQConfig = MUSIQConfig(),
                  key_map: Optional[Dict[str, str]] = None) -> Dict:
    """Canonical torch layout -> the flax tree. Linear `*.weight` transpose
    to kernels; `hse` accepts [G, G, D] or the TF [G*G, D] flattening.

    `key_map`: optional released-checkpoint rename pass, SOURCE key names
    (a TF google-research/musiq or pyiqa export) -> the canonical names
    consumed here; unmapped keys pass through unchanged."""
    if key_map is not None:
        state_dict = {key_map.get(k, k): v for k, v in state_dict.items()}
    params: Dict = {}

    def dense(prefix):
        return {"kernel": _to_numpy(state_dict[f"{prefix}.weight"]).T,
                "bias": _to_numpy(state_dict[f"{prefix}.bias"])}

    def norm(prefix):
        return {"scale": _to_numpy(state_dict[f"{prefix}.weight"]),
                "bias": _to_numpy(state_dict[f"{prefix}.bias"])}

    params["patch_proj"] = dense("patch_proj")
    g = cfg.grid_size
    params["hse"] = _to_numpy(state_dict["hse"]).reshape(g, g, -1)
    params["sce"] = _to_numpy(state_dict["sce"])
    params["cls"] = _to_numpy(state_dict["cls"]).reshape(-1)
    for i in range(cfg.num_layers):
        blk: Dict = {"norm1": norm(f"blocks.{i}.norm1"),
                     "norm2": norm(f"blocks.{i}.norm2")}
        for nm in ("q", "k", "v", "out"):
            blk[nm] = dense(f"blocks.{i}.attn.{nm}")
        blk["fc1"] = dense(f"blocks.{i}.mlp.fc1")
        blk["fc2"] = dense(f"blocks.{i}.mlp.fc2")
        params[f"block{i}"] = blk
    params["norm"] = norm("norm")
    params["head"] = dense("head")
    return params


_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "musiq.npz")


def build_musiq(tree: Mapping, cfg: MUSIQConfig, device="cuda") -> MUSIQ:
    device = resolve_device(device, "MUSIQ")
    return load_tree_(MUSIQ(cfg), tree).to(device).eval()


def make_musiq(weights_path: Optional[str] = None,
               cfg: Optional[MUSIQConfig] = None, device="cuda"):
    """MUSIQ callable `(img [H, W, 3] in [0,1]) -> float` on `device`, or
    None when no converted weights exist (harness reports UNAVAILABLE). The
    npz may carry the config JSON under `_config` (`save_musiq_weights`).
    `prepare` (host tokenisation + upload) and `net` are its halves."""
    device = resolve_device(device, "MUSIQ")
    path = weights_path or _DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    tree = load_lpips_params(path)
    blob = tree.pop("_config", None)
    if cfg is None:
        cfg = config_from_blob(MUSIQConfig, blob) if blob is not None else MUSIQConfig()
    run = network(build_musiq(tree, cfg, device))

    def prepare(img: np.ndarray):
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        toks = tokenize_multiscale(np.asarray(img, np.float32), cfg)
        return tuple(torch.as_tensor(t, device=device) for t in toks)

    def call(img: np.ndarray) -> float:
        return float(run(*prepare(img))[0])

    call.prepare, call.net = prepare, run
    return call


def save_musiq_weights(params: Dict, path: str,
                       cfg: Optional[MUSIQConfig] = None) -> None:
    """Write a self-contained MUSIQ npz (params + config JSON)."""
    extra: Dict = {}
    if cfg is not None:
        extra["_config"] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
    save_lpips_params({**params, **extra}, path)
