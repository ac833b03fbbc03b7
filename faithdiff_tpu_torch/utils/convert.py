"""Weights carried from the JAX package's parameter trees.

`state_dict_from_flax` turns a flax param tree (nested dicts of arrays, as
`jax.device_get(params["params"])` gives it) of the UNet, the VAE or the
denoise encoder into the port's state dict in diffusers / FaithDiff.bin
names. It is the port's own copy of the path -> key rules and layout
transforms of `faithdiff_tpu/utils/convert.py` (`_flax_path_to_torch_key`,
`export_to_torch_state_dict`): indexed module names `down_blocks_0` ->
`down_blocks.0`, the FaithDiff renames (`information_transformer_layes.*`,
packed `attn.in_proj_weight`, `spatial_ch_projs`), `to_out` -> `to_out.0`,
conv kernels HWIO -> OIHW, dense kernels transposed, norm `scale` ->
`weight`.

`clip_text_state_dict_from_flax` gives the SDXL text towers' transformers
`CLIPTextModel` / `CLIPTextModelWithProjection` keys, the inverse of
`faithdiff_tpu/utils/convert.py`'s `convert_clip_text`
(`position_embedding_raw` / `position_embedding` -> the position table,
`token_embedding.embedding`, layers under `text_model.encoder`); SDXL's own
tower files need only `text_model.embeddings.position_ids` dropped
(`clip_text_state_dict_from_reference`).

The captioner's carry functions (`llama_state_dict_from_flax`,
`clip_vision_state_dict_from_flax`, `projector_state_dict_from_flax`,
`mpt_state_dict_from_flax`) give transformers / LLaVA checkpoint keys, the
inverse of `faithdiff_tpu/utils/convert.py`'s `convert_llama`,
`convert_clip_vision`, `convert_vision_projector` and `convert_mpt`.
Quantised leaves (NF4 `packed` / `absmax`, int8 `values` / `scales`) carry
unchanged: the JAX bytes, shapes and dtypes become the buffers of
`NF4Dense` / `Int8Dense`.

The reference's own torch files need no layout change: their conv kernels
are OIHW and their dense weights [out, in], as the port's are, and the
port's module names are the reference's. What the reference's files need
is the FaithDiff.bin split (`split_faithdiff_bin`), the override of the
base SDXL UNet by FaithDiff.bin's core keys and the merge of its fusion
modules (`unet_state_dict_from_reference`); `export_faithdiff_bin` is the
inverse. The JAX package's renames (`_UNET_RENAMES`, the flax module
tree) and their inverse compose to the identity on these names, which the
tests hold.

The captioner's released files need as little: LLaVA-1.5's state dict is
transformers' LLaMA keys plus `model.mm_projector.{0,2}.*`
(`llava_state_dicts_from_reference` splits them and drops the rotary
tables), and openai's CLIP file keeps its `vision_model.*` keys without
`post_layernorm` and `position_ids` (`clip_vision_state_dict_from_reference`).
`bsrnet_state_dict_from_flax` carries the JAX BSRNet to the reference's
names.
"""
from __future__ import annotations

import re
import zipfile
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_INDEXED = ("down_blocks", "up_blocks", "resnets", "attentions",
            "transformer_blocks", "downsamplers", "upsamplers", "layers",
            "net")


def _flatten(tree: Mapping[str, Any],
             prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _path_to_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax param path -> (state-dict key, transform), transform one of
    "auto" (conv or dense kernel), "linear" (packed qkv), "raw"."""
    parts = []
    for p in path[:-1]:
        for base in _INDEXED:
            if p.startswith(base + "_") and p[len(base) + 1:].isdigit():
                parts.extend([base, p[len(base) + 1:]])
                break
        else:
            parts.append(p)
    key = ".".join(parts)
    key = key.replace("information_transformer.layers.",
                      "information_transformer_layes.")
    key = key.replace("information_transformer.spatial_ch_projs",
                      "spatial_ch_projs")
    key = re.sub(r"(information_transformer_layes\.\d+)\.in_proj$",
                 r"\1.attn", key)
    key = re.sub(r"(information_transformer_layes\.\d+)\.out_proj$",
                 r"\1.attn.out_proj", key)
    key = re.sub(r"(information_transformer_layes\.\d+)\.mlp_c_(fc|proj)$",
                 r"\1.mlp.c_\2", key)
    if key.endswith("to_out"):
        key += ".0"
    leaf = path[-1]
    if leaf == "kernel":
        if key.endswith(".attn"):
            return key + ".in_proj_weight", "linear"
        return key + ".weight", "auto"
    if leaf == "scale":
        return key + ".weight", "raw"
    if leaf == "bias":
        if key.endswith(".attn"):
            return key + ".in_proj_bias", "raw"
        return key + ".bias", "raw"
    raise KeyError(f"unhandled flax leaf {'/'.join(path)}")


def flax_param_path(key: str, ndim: int) -> Tuple[str, ...]:
    """The flax param path (without "params") that `_path_to_key` carries
    to the state-dict entry `key` of an `ndim`-D tensor: its inverse. A
    `.weight` of 2 or more dims is a dense or conv `kernel`, of one dim a
    norm `scale`. Raises KeyError on a key no flax path gives."""
    if key.endswith(".in_proj_weight"):
        module, leaf = key[:-len(".in_proj_weight")], "kernel"
    elif key.endswith(".in_proj_bias"):
        module, leaf = key[:-len(".in_proj_bias")], "bias"
    elif key.endswith(".weight"):
        module, leaf = key[:-len(".weight")], "kernel" if ndim >= 2 else "scale"
    elif key.endswith(".bias"):
        module, leaf = key[:-len(".bias")], "bias"
    else:
        raise KeyError(f"no flax path for {key}")
    module = re.sub(r"to_out\.0$", "to_out", module)
    module = re.sub(r"(information_transformer_layes\.\d+)\.attn\.out_proj$",
                    r"\1.out_proj", module)
    module = re.sub(r"(information_transformer_layes\.\d+)\.attn$",
                    r"\1.in_proj", module)
    module = re.sub(r"(information_transformer_layes\.\d+)\.mlp\.c_(fc|proj)$",
                    r"\1.mlp_c_\2", module)
    module = module.replace("information_transformer_layes.",
                            "information_transformer.layers.")
    if module.startswith("spatial_ch_projs"):
        module = "information_transformer." + module
    parts = module.split(".")
    path = []
    for p in parts:
        if p.isdigit() and path and path[-1] in _INDEXED:
            path[-1] = f"{path[-1]}_{p}"
        else:
            path.append(p)
    path = tuple(path) + (leaf,)
    if _path_to_key(path)[0] != key:
        raise KeyError(f"no flax path for {key}")
    return path


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params of the UNet, the VAE or the denoise encoder -> the
    port's state dict (fp32 tensors), ready for `load_state_dict(strict=True)`.

    Accepts the tree with or without its top-level "params" key. The
    denoise encoder's flax tree nests its trunk under "encoder"; a tree
    whose only key is "encoder" loses that level, so its keys are
    FaithDiff.bin's `denoise_encoder.*` keys without the namespace."""
    if set(params) == {"params"}:
        params = params["params"]
    if set(params) == {"encoder"}:
        params = params["encoder"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        key, transform = _path_to_key(path)
        arr = np.asarray(leaf, dtype=np.float32)
        if transform == "auto":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T
        elif transform == "linear":
            arr = arr.T
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


# ---------------------------------------------------------------------------
# the reference's torch files (diffusers UNet / VAE, FaithDiff.bin)
# ---------------------------------------------------------------------------

# FaithDiff.bin's namespaces beside the core UNet keys
FAITHDIFF_NAMESPACES = ("denoise_encoder", "information_transformer_layes",
                        "condition_embedding", "agg_net", "spatial_ch_projs")
# the ones that belong to the fusion UNet (`agg_net` has no module in the
# JAX package or the port, and is dropped as the JAX conversion drops it)
UNET_EXTRAS = ("information_transformer_layes", "condition_embedding",
               "spatial_ch_projs")


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A .bin / .pth state dict (`{"state_dict": ...}` unwrapped) as CPU
    tensors. `weights_only=True`: the file may hold tensors and plain
    containers only, which is all a state dict is, and nothing is
    unpickled that could run code. A zip-format file is memory-mapped."""
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def split_faithdiff_bin(
    state_dict: Mapping[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
    """Split the flat FaithDiff.bin layout into (core UNet keys, {namespace:
    keys without it}), as the reference's `load_state_dict` does."""
    core: Dict[str, Any] = {}
    extras: Dict[str, Dict[str, Any]] = {ns: {} for ns in FAITHDIFF_NAMESPACES}
    for key, value in state_dict.items():
        for ns in FAITHDIFF_NAMESPACES:
            if key.startswith(ns + "."):
                extras[ns][key[len(ns) + 1:]] = value
                break
        else:
            core[key] = value
    return core, extras


def unet_state_dict_from_reference(unet_sd: Mapping[str, Any],
                                   faithdiff_sd: Mapping[str, Any]
                                   ) -> Dict[str, Any]:
    """The port's fusion-UNet state dict from the base SDXL UNet's keys and
    FaithDiff.bin: its core keys override the base (the reference loads
    them non-strictly over it), and its fusion modules join under their
    own names."""
    core, extras = split_faithdiff_bin(faithdiff_sd)
    merged = {**unet_sd, **core}
    for ns in UNET_EXTRAS:
        merged.update({f"{ns}.{k}": v for k, v in extras[ns].items()})
    return merged


def denoise_encoder_state_dict_from_reference(
        faithdiff_sd: Mapping[str, Any]) -> Dict[str, Any]:
    """FaithDiff.bin's `denoise_encoder.*` keys, without the namespace: the
    port's `DenoiseEncoder` state dict."""
    return split_faithdiff_bin(faithdiff_sd)[1]["denoise_encoder"]


def export_faithdiff_bin(unet_sd: Mapping[str, Any],
                         denoise_encoder_sd: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, Any]:
    """The port's UNet and denoise-encoder state dicts in FaithDiff.bin's
    layout: the core UNet and the fusion modules under their names, the
    denoise encoder under `denoise_encoder.` (the inverse of the two
    functions above)."""
    out = dict(unet_sd)
    out.update({f"denoise_encoder.{k}": v
                for k, v in (denoise_encoder_sd or {}).items()})
    return out


# ---------------------------------------------------------------------------
# captioner
# ---------------------------------------------------------------------------

# quantised leaves keep their name, bytes, shape and dtype
_QUANT_LEAVES = ("packed", "absmax", "values", "scales")


def _unwrap(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if set(params) == {"params"} else params


def _index(name: str, base: str) -> str:
    """`layers_3` -> `layers.3` (flax list-module names)."""
    if name.startswith(base + "_") and name[len(base) + 1:].isdigit():
        return f"{base}.{name[len(base) + 1:]}"
    return name


def _carry_leaf(prefix: str, leaf: str, value: Any) -> Tuple[str, torch.Tensor]:
    """One flax leaf -> (state-dict key, tensor): dense kernels transposed,
    conv kernels HWIO -> OIHW, `embedding` / `scale` -> `weight`, quantised
    leaves unchanged, float leaves as fp32."""
    arr = np.asarray(value)
    if leaf in _QUANT_LEAVES:
        return f"{prefix}.{leaf}", torch.from_numpy(np.array(arr))
    arr = arr.astype(np.float32)
    if leaf == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        leaf = "weight"
    elif leaf in ("embedding", "scale"):
        leaf = "weight"
    elif leaf not in ("weight", "bias"):
        raise KeyError(f"unhandled flax leaf {prefix}/{leaf}")
    return f"{prefix}.{leaf}", torch.from_numpy(np.ascontiguousarray(arr))


def _carry(params: Mapping[str, Any], rename) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(_unwrap(params)):
        key, tensor = _carry_leaf(rename(path[:-1]), path[-1], value)
        out[key] = tensor
    return out


def llama_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `LlamaForCausalLM` params (fp, int8 or nf4) -> the port's state
    dict in transformers names: `model.embed_tokens.weight`,
    `model.layers.{i}.self_attn.{q,k,v,o}_proj.*`,
    `model.layers.{i}.mlp.{gate,up,down}_proj.*`, `model.norm.weight`,
    `lm_head.*`."""
    def rename(path):
        if path[0] == "embed_tokens":
            return "model.embed_tokens"
        parts = [_index(p, "layers") for p in path]
        if parts[-1] in ("gate_proj", "up_proj", "down_proj"):
            parts.insert(-1, "mlp")
        return ".".join(parts)

    return _carry(params, rename)


def clip_vision_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `CLIPVisionTower` params -> the port's state dict in transformers
    `CLIPVisionModel` names (`vision_model.embeddings.*`,
    `vision_model.pre_layrnorm.*`, `vision_model.encoder.layers.{i}.*`)."""
    params = dict(_unwrap(params))
    out = {"vision_model.embeddings.class_embedding":
           torch.from_numpy(np.asarray(params.pop("class_embedding"), np.float32).copy()),
           "vision_model.embeddings.position_embedding.weight":
           torch.from_numpy(np.asarray(params.pop("position_embedding"), np.float32).copy())}

    def rename(path):
        if path[0] == "patch_embedding":
            return "vision_model.embeddings.patch_embedding"
        if path[0] == "pre_layrnorm":
            return "vision_model.pre_layrnorm"
        layer, sub = _index(path[0], "layers"), path[1]
        group = ("self_attn." if sub.endswith("_proj")
                 else "mlp." if sub in ("fc1", "fc2") else "")
        return f"vision_model.encoder.{layer}.{group}{sub}"

    out.update(_carry(params, rename))
    return out


def projector_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `VisionProjector` params (`linear_0`, `linear_2`) -> LLaVA's
    `mm_projector` keys without the namespace (`0.*`, `2.*`)."""
    return _carry(params, lambda path: path[0].replace("linear_", ""))


def mpt_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `MPTForCausalLM` params -> transformers MPT names
    (`transformer.wte.weight`, `transformer.blocks.{i}.attn.Wqkv.weight`,
    `transformer.blocks.{i}.ffn.up_proj.weight`, `transformer.norm_f.weight`)."""
    def rename(path):
        parts = [_index(p, "blocks") for p in path]
        if parts[-1] in ("up_proj", "down_proj"):
            parts.insert(-1, "ffn")
        return "transformer." + ".".join(parts)

    return _carry(params, rename)


# the released LLaVA-1.5 file's projector keys, and the keys the port's
# modules have no place for: transformers' rotary tables (saved by the
# releases of its 4.31 era) and a CLIP file's post-layernorm (LLaVA takes
# the hidden states before it), position ids, text tower and projections
LLAVA_PROJECTOR = "model.mm_projector."
_DROPPED_LLAMA = re.compile(r"(^|\.)rotary_emb\.inv_freq$|^model\.vision_tower\.")
_KEPT_CLIP = re.compile(r"^vision_model\.")
_DROPPED_CLIP = re.compile(r"^vision_model\.(post_layernorm\.|embeddings\.position_ids$)")


def llava_state_dicts_from_reference(
    sd: Mapping[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A released LLaVA-1.5 state dict (or one shard of it) -> (the port's
    `LlamaForCausalLM` keys, the `VisionProjector` keys): the projector's
    `model.mm_projector.{0,2}.*` lose their namespace, the rotary tables
    and any vision-tower keys go, the rest are transformers' names already
    (the counterpart of `convert_llama` / `convert_vision_projector`)."""
    llama: Dict[str, Any] = {}
    projector: Dict[str, Any] = {}
    for key, value in sd.items():
        if key.startswith(LLAVA_PROJECTOR):
            projector[key[len(LLAVA_PROJECTOR):]] = value
        elif not _DROPPED_LLAMA.search(key):
            llama[key] = value
    return llama, projector


def clip_vision_state_dict_from_reference(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """openai/clip-vit-large-patch14-336's state dict (a whole CLIPModel or
    a CLIPVisionModel) -> the port's `CLIPVisionTower` keys: `vision_model.*`
    without `post_layernorm` and `position_ids` (the counterpart of
    `convert_clip_vision`); the text tower, `visual_projection`,
    `text_projection` and `logit_scale` go."""
    return {k: v for k, v in sd.items()
            if _KEPT_CLIP.match(k) and not _DROPPED_CLIP.match(k)}


def bsrnet_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `RRDBNet` params -> the reference BSRNet's keys (`conv_first`,
    `RRDB_trunk.{i}.RDB{1,2,3}.conv{1..5}`, `trunk_conv`, `upconv1/2`,
    `HRconv`, `conv_last`), conv kernels HWIO -> OIHW."""
    return _carry(params, lambda path: ".".join(_index(p, "RRDB_trunk") for p in path))


TEXT_TOWERS = ("text_encoder", "text_encoder_2")


def clip_text_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax `CLIPTextTower` params -> the port's `CLIPTextTower` state dict
    in transformers names (`text_model.embeddings.*`,
    `text_model.encoder.layers.{i}.*`, `text_model.final_layer_norm.*`,
    `text_projection.weight`); `SDXLTextEncoder` params (`text_encoder`,
    `text_encoder_2`) -> both, each under its tower's name."""
    params = dict(_unwrap(params))
    if set(params) == set(TEXT_TOWERS):
        return {f"{tower}.{k}": v for tower in TEXT_TOWERS
                for k, v in clip_text_state_dict_from_flax(params[tower]).items()}
    pos = np.asarray(params.pop("position_embedding"), np.float32)
    out = {"text_model.embeddings.position_embedding.weight":
           torch.from_numpy(np.ascontiguousarray(pos))}

    def rename(path):
        if path[0] == "token_embedding":
            return "text_model.embeddings.token_embedding"
        if path[0] in ("final_layer_norm", "text_projection"):
            return ("text_model." if path[0] == "final_layer_norm" else "") + path[0]
        return ".".join(["text_model.encoder", _index(path[0], "layers")]
                        + list(path[1:]))

    out.update(_carry(params, rename))
    return out


def clip_text_state_dict_from_reference(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A transformers text tower's state dict (SDXL's `text_encoder*/`) ->
    the port's `CLIPTextTower` keys: the same names without the
    `position_ids` buffer."""
    return {k: v for k, v in sd.items()
            if k != "text_model.embeddings.position_ids"}
