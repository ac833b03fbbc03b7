"""CLIP vision tower (ViT-L/14-336) and the mlp2x projector of the
captioner (counterpart of `faithdiff_tpu/captioner/clip_vision.py`).

Module names follow the transformers `CLIPVisionModel` state dict
(`vision_model.embeddings.patch_embedding`, `vision_model.pre_layrnorm`,
`vision_model.encoder.layers.{i}.self_attn.q_proj`, ...) and LLaVA's
`mm_projector` (`0`, `2`), so a released checkpoint loads without a rename
layer. The tower takes NHWC pixels, as the JAX one does, selects hidden
layer -2 (running 23 of 24 layers) and drops the CLS token.

Image preprocessing needs no PIL: `resize_bicubic` (`utils/resample.py`)
is Pillow's BICUBIC resample for uint8 images, in numpy.
"""
from __future__ import annotations

import ast
import dataclasses
import math
from typing import List

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import LayerNorm, quick_gelu
from ..ops.attention import multi_head_attention
from ..utils.resample import resize_bicubic

# CLIP image normalisation (OPENAI_CLIP_MEAN/STD)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def tiny_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=56, patch_size=14, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d, dtype=dtype)
        self.k_proj = nn.Linear(d, d, dtype=dtype)
        self.v_proj = nn.Linear(d, d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, -1).transpose(1, 2).contiguous()

        out = multi_head_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                   split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        if cfg.hidden_act != "quick_gelu":
            raise ValueError(f"CLIP hidden_act {cfg.hidden_act!r}: only quick_gelu")
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d, dtype=dtype))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size,
                                         bias=False, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, d, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NHWC pixels -> [B, 1 + patches, hidden]: CLS, then the patches in
        row-major order, plus the position embedding."""
        w = self.patch_embedding.weight
        x = pixel_values.to(w.dtype).permute(0, 3, 1, 2)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg, dtype)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg, dtype)


class CLIPVisionTower(nn.Module):
    """Patch features of hidden layer `select_layer` (default -2), CLS
    dropped: NHWC CLIP-normalised pixels [B, S, S, 3] -> [B, patches, hidden].
    Only the layers up to the selected one run."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(),
                 select_layer: int = -2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.select_layer = config, select_layer
        self.vision_model = CLIPVisionTransformer(config, dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(pixel_values))
        n_run = self.config.num_hidden_layers + self.select_layer + 1
        for layer in vm.encoder.layers[:n_run]:
            x = layer(x)
        return x[:, 1:, :]


class VisionProjector(nn.Sequential):
    """LLaVA's mlp2x_gelu `mm_projector`: Linear, exact-erf GELU, Linear."""

    def __init__(self, out_dim: int = 5120, in_dim: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Linear(in_dim, out_dim, dtype=dtype), nn.GELU(),
                         nn.Linear(out_dim, out_dim, dtype=dtype))


def preprocess_clip_image(img: np.ndarray, image_size: int = 336,
                          pad_square: bool = True) -> np.ndarray:
    """HWC uint8 -> [1, S, S, 3] CLIP-normalised: expand2square with the
    mean colour, bicubic resize, normalise (`llava/mm_utils.py:119-183`)."""
    h, w = img.shape[:2]
    if pad_square and h != w:
        side = max(h, w)
        bg = np.tile((CLIP_MEAN * 255).astype(np.uint8), (side, side, 1))
        y0, x0 = (side - h) // 2, (side - w) // 2
        bg[y0:y0 + h, x0:x0 + w] = img
        img = bg
    img = resize_bicubic(img, (image_size, image_size))
    x = img.astype(np.float32) / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    return x[None]


# ---------------------------------------------------------------------------
# anyres preprocessing (`llava/mm_utils.py:12-145`; LLaVA-1.6-style
# checkpoints; LLaVA-1.5, the FaithDiff captioner, uses the square path)
# ---------------------------------------------------------------------------

def select_best_resolution(original_size, possible_resolutions):
    """The grid resolution that keeps the most effective pixels and wastes
    the fewest. Sizes are (width, height)."""
    ow, oh = original_size
    best, best_eff, min_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < min_waste):
            best_eff, min_waste, best = eff, waste, (w, h)
    return best


def resize_and_pad_image(img: np.ndarray, target_resolution) -> np.ndarray:
    """Aspect-preserving bicubic resize, then centre-pad with black to
    (width, height)."""
    oh, ow = img.shape[:2]
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = resize_bicubic(img, (nw, nh))
    out = np.zeros((th, tw, 3), img.dtype)
    y0, x0 = (th - nh) // 2, (tw - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = resized
    return out


def divide_to_patches(img: np.ndarray, patch_size: int) -> List[np.ndarray]:
    """Row-major square crops."""
    h, w = img.shape[:2]
    return [img[i:i + patch_size, j:j + patch_size]
            for i in range(0, h, patch_size) for j in range(0, w, patch_size)]


def process_anyres_image(img: np.ndarray, image_size: int,
                         grid_pinpoints) -> np.ndarray:
    """Image -> [1 + n_patches, S, S, 3] CLIP-normalised stack: the resized
    base image first, then the best grid's patches."""
    if isinstance(grid_pinpoints, str):
        grid_pinpoints = ast.literal_eval(grid_pinpoints)
    best = select_best_resolution((img.shape[1], img.shape[0]), grid_pinpoints)
    patches = divide_to_patches(resize_and_pad_image(img, best), image_size)
    base = resize_bicubic(img, (image_size, image_size))
    return np.concatenate([preprocess_clip_image(p, image_size, pad_square=False)
                           for p in [base] + patches])
