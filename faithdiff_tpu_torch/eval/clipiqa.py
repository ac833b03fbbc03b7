"""CLIPIQA (CLIP-based no-reference image quality, Wang et al. 2023;
counterpart of `faithdiff_tpu/eval/clipiqa.py`).

The score is the softmax over CLIP similarities against an antonym prompt
pair:

    score = softmax([cos(img, "Good photo."), cos(img, "Bad photo.")]
                    * logit_scale)[good]

The dual tower is the port's own: the captioner's CLIP vision layers
(`captioner/clip_vision.py`) with the pooled + projected CLS on top, and
SDXL's text tower (`models/clip_text.CLIPTextTower`). The ViT-L/14 at 512
px runs 1,297 tokens, which the JAX package's flash gate refuses (a
multiple of 128 is asked for): its attention stays plain torch in fp32
here too (`use_flash=False`). The position embeddings of a 224 / 336
checkpoint are interpolated to the input's patch grid as
`jax.image.resize(..., "bilinear")` does it (`data.degradation.resize`,
"area": its border weights differ from `F.interpolate`'s, which clamps).

CLIPIQA+ learned prompts come as prompt *embeddings* (`prompt_embeds`)
instead of token ids. Weights-gated: the JAX harness's npz, with the
configs under `_config` and the prompts under `_prompt_ids` /
`_prompt_embeds`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..captioner.clip_vision import (CLIP_MEAN, CLIP_STD, CLIPVisionConfig,
                                     CLIPVisionTransformer)
from ..config import CLIPTextConfig
from ..data.degradation import resize
from ..models.clip_text import EOS_TOKEN_ID, CLIPTextTower
from ..models.layers import LayerNorm
from ..utils.resample import resize_bicubic
from .lpips import (_to_numpy, fp32_exact, load_lpips_params, load_tree_,
                    resolve_device, save_lpips_params, tree_from_module)


class CLIPImageEncoder(nn.Module):
    """ViT trunk -> post-LayerNorm CLS -> visual projection [B, proj]."""

    def __init__(self, config: CLIPVisionConfig, projection_dim: int = 768):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config, torch.float32)
        for layer in self.vision_model.encoder.layers:
            layer.self_attn.use_flash = False
        self.post_layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.visual_projection = nn.Linear(config.hidden_size, projection_dim,
                                           bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: [B, H, W, 3] CLIP-normalised."""
        cfg, emb = self.config, self.vision_model.embeddings
        patches = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        b, d, gh, gw = patches.shape
        patches = patches.flatten(2).transpose(1, 2)
        pos = emb.position_embedding.weight
        side = int(np.sqrt(cfg.num_patches))
        if gh != side or gw != side:
            # the patch-grid position embeddings resized to the input's grid
            # (how pyiqa runs ViT-L/14 at 512)
            grid = resize(pos[1:].reshape(1, side, side, d), (gh, gw), "area")
            pos = torch.cat([pos[:1], grid.reshape(gh * gw, d)], dim=0)
        x = torch.cat([emb.class_embedding.expand(b, 1, d), patches], dim=1)
        x = self.vision_model.pre_layrnorm(x + pos[None])
        for layer in self.vision_model.encoder.layers:
            x = layer(x)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


class CLIPIQA(nn.Module):
    def __init__(self, vision_config: CLIPVisionConfig,
                 text_config: CLIPTextConfig, eos_token_id: int = EOS_TOKEN_ID,
                 text_tower: bool = True):
        """`text_tower` False: prompt embeddings only (a file without the
        text tower's weights)."""
        super().__init__()
        self.vision = CLIPImageEncoder(vision_config,
                                       projection_dim=text_config.projection_dim)
        self.text = CLIPTextTower(text_config) if text_tower else None
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(100.0))))
        self.eos_token_id = eos_token_id

    def forward(self, pixel_values, prompt_ids=None, prompt_embeds=None):
        """pixel_values: [B, H, W, 3] CLIP-normalised; prompt_ids: [2, 77]
        (good, bad) token ids, or precomputed [2, proj] `prompt_embeds`
        (the CLIPIQA+ learned-prompt path). Returns [B] quality in (0, 1)."""
        img = self.vision(pixel_values)
        if prompt_embeds is None:
            if self.text is None:
                raise ValueError("CLIPIQA: prompt ids need the text tower's "
                                 "weights")
            _, _, prompt_embeds = self.text(prompt_ids, eos_token_id=self.eos_token_id)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = prompt_embeds / prompt_embeds.norm(dim=-1, keepdim=True)
        logits = self.logit_scale.exp() * img @ txt.T          # [B, 2]
        return logits.softmax(dim=-1)[:, 0]


def flax_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """The port's key (leaf renamed as `eval.lpips` does) -> the JAX
    CLIPIQA tree's path: the transformers levels (`vision_model`,
    `text_model`, `embeddings`, `encoder`) go, `layers.i` is `layers_i`,
    the vision layers hold their projections and MLP directly, and the
    position tables are bare arrays."""
    parts = [p for p in path
             if p not in ("vision_model", "text_model", "embeddings", "encoder")]
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers":
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if out[0] == "vision":
        out = [p for p in out if p not in ("self_attn", "mlp")]
    if out[-2:] == ["position_embedding", "embedding"]:
        out = out[:-1]
    return tuple(out)


def clip_vit_l14_configs() -> Tuple[CLIPVisionConfig, CLIPTextConfig]:
    vision = CLIPVisionConfig(image_size=224, patch_size=14,
                              hidden_size=1024, intermediate_size=4096,
                              num_hidden_layers=24, num_attention_heads=16)
    text = dataclasses.replace(CLIPTextConfig.sdxl_text_encoder(),
                               projection_dim=768)   # the ViT-L/14 text tower
    return vision, text


def convert_clip_model(state_dict: Dict) -> Dict:
    """transformers `CLIPModel` state dict -> the CLIPIQA flax tree."""
    vision: Dict = {}
    text: Dict = {}
    out: Dict = {"vision": vision, "text": text}

    def put(tree, parts, value):
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def leaf(name):
        return "scale" if name == "weight" else "bias"

    for key, v in state_dict.items():
        arr = _to_numpy(v)
        parts = key.split(".")
        if key == "logit_scale":
            out["logit_scale"] = arr
        elif key == "visual_projection.weight":
            put(vision, ("visual_projection", "kernel"), arr.T)
        elif key == "text_projection.weight":
            put(text, ("text_projection", "kernel"), arr.T)
        elif parts[0] == "vision_model":
            sub = parts[1:]
            if sub[0] == "embeddings":
                if sub[1] == "patch_embedding":
                    put(vision, ("patch_embedding", "kernel"),
                        arr.transpose(2, 3, 1, 0))
                elif sub[1] == "class_embedding":
                    vision["class_embedding"] = arr.reshape(-1)
                elif sub[1] == "position_embedding":
                    vision["position_embedding"] = arr
            elif sub[0] in ("pre_layrnorm", "post_layernorm"):
                put(vision, (sub[0], leaf(sub[1])), arr)
            elif sub[0] == "encoder":
                i, rest = sub[2], sub[3:]
                name = rest[0]
                if name in ("layer_norm1", "layer_norm2"):
                    put(vision, (f"layers_{i}", name, leaf(rest[1])), arr)
                elif name in ("self_attn", "mlp"):
                    put(vision, (f"layers_{i}", rest[1],
                                 "kernel" if rest[2] == "weight" else "bias"),
                        arr.T if rest[2] == "weight" else arr)
        elif parts[0] == "text_model":
            sub = parts[1:]
            if sub[0] == "embeddings":
                if sub[1] == "token_embedding":
                    put(text, ("token_embedding", "embedding"), arr)
                elif sub[1] == "position_embedding":
                    text["position_embedding"] = arr
            elif sub[0] == "final_layer_norm":
                put(text, ("final_layer_norm", leaf(sub[1])), arr)
            elif sub[0] == "encoder":
                i, rest = sub[2], sub[3:]
                name = rest[0]
                if name in ("layer_norm1", "layer_norm2"):
                    put(text, (f"layers_{i}", name, leaf(rest[1])), arr)
                elif name in ("self_attn", "mlp"):
                    put(text, (f"layers_{i}", name, rest[1],
                               "kernel" if rest[2] == "weight" else "bias"),
                        arr.T if rest[2] == "weight" else arr)
    return out


_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "clipiqa.npz")


def save_clipiqa_weights(params: Dict, path: str,
                         vision_cfg: Optional[CLIPVisionConfig] = None,
                         text_cfg: Optional[CLIPTextConfig] = None,
                         eos_token_id: int = EOS_TOKEN_ID,
                         prompt_ids: Optional[np.ndarray] = None,
                         prompt_embeds: Optional[np.ndarray] = None) -> None:
    """Write a self-contained CLIPIQA npz: converted params plus the model
    configs (JSON under `_config`) and the antonym prompts, so the harness
    can rebuild the metric from the file alone."""
    extra: Dict = {}
    if vision_cfg is not None and text_cfg is not None:
        extra["_config"] = np.asarray(json.dumps({
            "vision": dataclasses.asdict(vision_cfg),
            "text": dataclasses.asdict(text_cfg),
            "eos_token_id": eos_token_id,
        }))
    if prompt_ids is not None:
        extra["_prompt_ids"] = np.asarray(prompt_ids, np.int32)
    if prompt_embeds is not None:
        extra["_prompt_embeds"] = np.asarray(prompt_embeds, np.float32)
    save_lpips_params({**params, **extra}, path)


def clipiqa_tree(model: CLIPIQA) -> Dict:
    """`model`'s parameters as the JAX CLIPIQA tree (`save_clipiqa_weights`
    writes it)."""
    return tree_from_module(model, flax_path)


def build_clipiqa(tree: Mapping, vision_cfg: CLIPVisionConfig,
                  text_cfg: CLIPTextConfig, eos_token_id: int = EOS_TOKEN_ID,
                  device="cuda") -> CLIPIQA:
    device = resolve_device(device, "CLIPIQA")
    model = CLIPIQA(vision_cfg, text_cfg, eos_token_id, text_tower="text" in tree)
    return load_tree_(model, tree, flax_path).to(device).eval()


def make_clipiqa(weights_path: Optional[str] = None,
                 prompt_ids: Optional[np.ndarray] = None,
                 prompt_embeds: Optional[np.ndarray] = None,
                 resolution: int = 512, device="cuda"):
    """CLIPIQA callable `(img in [0,1]) -> float` on `device`, or None
    without weights.

    `prompt_ids` [2, 77] tokenizes ("Good photo.", "Bad photo."); CLIPIQA+
    checkpoints provide learned `prompt_embeds` [2, proj] instead. The
    weights npz may carry either under the reserved keys `_prompt_ids` /
    `_prompt_embeds`. `prepare` (Pillow BICUBIC to `resolution`, CLIP
    normalisation, upload) and `net` are its halves."""
    device = resolve_device(device, "CLIPIQA")
    path = weights_path or _DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    tree = load_lpips_params(path)
    if prompt_ids is None and prompt_embeds is None:
        prompt_ids = tree.pop("_prompt_ids", None)
        prompt_embeds = tree.pop("_prompt_embeds", None)
    else:
        tree.pop("_prompt_ids", None)
        tree.pop("_prompt_embeds", None)
    if prompt_ids is None and prompt_embeds is None:
        return None
    cfg_blob = tree.pop("_config", None)
    eos_token_id = EOS_TOKEN_ID
    if cfg_blob is not None:
        cfg = json.loads(str(np.asarray(cfg_blob)))
        vision_cfg = CLIPVisionConfig(**cfg["vision"])
        text_cfg = CLIPTextConfig(**cfg["text"])
        eos_token_id = int(cfg.get("eos_token_id", eos_token_id))
    else:
        vision_cfg, text_cfg = clip_vit_l14_configs()
    model = build_clipiqa(tree, vision_cfg, text_cfg, eos_token_id, device)
    if prompt_embeds is not None:
        prompts = {"prompt_embeds": torch.as_tensor(
            np.asarray(prompt_embeds, np.float32), device=device)}
    else:
        prompts = {"prompt_ids": torch.as_tensor(np.asarray(prompt_ids),
                                                 device=device)}
    mean = torch.as_tensor(CLIP_MEAN, device=device)
    std = torch.as_tensor(CLIP_STD, device=device)

    def prepare(img: np.ndarray):
        if img.dtype != np.uint8:
            img = np.uint8(np.clip(img, 0, 1) * 255)
        img = resize_bicubic(img, (resolution, resolution))
        x = torch.as_tensor(img, device=device).float() / 255.0
        return ((x - mean) / std)[None],

    def net(x):
        with torch.no_grad(), fp32_exact():
            return model(x, **prompts)

    def call(img: np.ndarray) -> float:
        return float(net(*prepare(img))[0])

    call.prepare, call.net = prepare, net
    return call
