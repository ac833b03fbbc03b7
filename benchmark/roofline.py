"""Peaks of the card and the work of the restore path, counted from shapes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit). A kernel's least time is the larger of its operations
over the peak rate and its bytes over the memory bandwidth, each input read
once and each output written once. The work is counted from the
configuration's shapes on the plain reference (`reference.models`) on the
meta device, so it is the same whatever kernel computes it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.models import GroupNorm, build_models

PEAK_BF16_FLOPS = 989e12    # tensor cores, bf16 / fp16
PEAK_FP32_FLOPS = 67e12     # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def attention_work(batch: int, heads: int, tokens: int, kv_tokens: int,
                   head_dim: int, esize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one non-causal attention: q k^T and p v, each
    2 * rows * keys * d a plane; q, k, v and o moved once."""
    planes = batch * heads
    flops = 4.0 * planes * tokens * kv_tokens * head_dim
    nbytes = esize * planes * head_dim * (2 * tokens + 2 * kv_tokens)
    return flops, nbytes


def group_norm_work(shape, act: bool, add: bool, esize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one GroupNorm: mean, variance, normalise, affine
    (5 a value), SiLU (4 more); x read and y written once, the per-(batch,
    channel) add read once."""
    numel = math.prod(shape)
    flops = numel * (5 + (4 if act else 0))
    nbytes = esize * (2 * numel + (shape[0] * shape[1] if add else 0))
    return flops, nbytes


def unet_self_attention(unet_cfg: dict, latent_hw: Tuple[int, int],
                        batch: int) -> List[Tuple[int, int, int, int]]:
    """(batch, heads, tokens, head_dim) of every spatial self-attention of
    one UNet call on `batch` latents of `latent_hw`."""
    ch = unet_cfg["block_out_channels"]
    heads = unet_cfg["attention_head_dim"]
    depth = unet_cfg["transformer_layers_per_block"]
    layers = unet_cfg["layers_per_block"]
    out = []
    n = len(ch)
    for i, kind in enumerate(unet_cfg["down_block_types"]):
        if kind.startswith("CrossAttn"):
            tokens = (latent_hw[0] >> i) * (latent_hw[1] >> i)
            out += [(batch, heads[i], tokens, ch[i] // heads[i])] * (layers * depth[i])
    tokens = (latent_hw[0] >> (n - 1)) * (latent_hw[1] >> (n - 1))
    out += [(batch, heads[-1], tokens, ch[-1] // heads[-1])] * depth[-1]
    for i, kind in enumerate(unet_cfg["up_block_types"]):
        r = n - 1 - i
        if kind.startswith("CrossAttn"):
            tokens = (latent_hw[0] >> r) * (latent_hw[1] >> r)
            out += [(batch, heads[r], tokens, ch[r] // heads[r])] * ((layers + 1) * depth[r])
    return out


def flash_least_seconds(unet_cfg: dict, latent_hw, batch: int) -> float:
    """Least time of the UNet's self-attention in one call."""
    return sum(least_seconds(*attention_work(b, h, s, s, d), PEAK_BF16_FLOPS)
               for b, h, s, d in unet_self_attention(unet_cfg, latent_hw, batch))


def unet_batches(tiles: int, tile_chunk: int) -> list:
    """The UNet's call batches in one step: each tile's CFG pair, in calls
    of at most `tile_chunk` tiles."""
    return [2 * min(tile_chunk, tiles - lo) for lo in range(0, tiles, tile_chunk)]


def flash_least_restore(unet_cfg: dict, latent_hw, tiles: int, tile_chunk: int,
                        steps: int) -> float:
    """Least time of the UNet's self-attention in one whole restore."""
    return steps * sum(flash_least_seconds(unet_cfg, latent_hw, b)
                       for b in unet_batches(tiles, tile_chunk))


def _meta_inputs(config: dict, height: int, width: int, unet_batch: int,
                 prompt_tokens: int = 77):
    u = config["unet"]
    pooled = u["projection_class_embeddings_input_dim"] - 6 * u["addition_time_embed_dim"]
    lh, lw = height // 8, width // 8
    k1, k2 = min(config["pipeline"]["tile_size"] // 8, lh), min(config["pipeline"]["tile_size"] // 8, lw)
    with torch.device("meta"):
        image = torch.empty(1, 3, height, width)
        latents = torch.empty(1, config["vae"]["latent_channels"], lh, lw)
        unet_args = (torch.empty(unet_batch, u["in_channels"], k1, k2), 999.0,
                     torch.empty(unet_batch, prompt_tokens, u["cross_attention_dim"]),
                     torch.empty(unet_batch, pooled), torch.empty(unet_batch, 6),
                     torch.empty(unet_batch, u["condition_channels"], k1, k2))
    return image, latents, unet_args


def _stages(config: dict, height: int, width: int, unet_batch: int,
            prompt_tokens: int = 77):
    """The restore's stages on the meta device: (name, thunk) of the denoise
    encoder, the VAE encode, one UNet call and the VAE decode."""
    models = build_models(config, "meta")
    image, latents, unet_args = _meta_inputs(config, height, width, unet_batch,
                                             prompt_tokens)
    return [("denoise_encoder", lambda: models["denoise_encoder"](image)),
            ("vae_encode", lambda: models["vae"].encode_moments(image)),
            ("unet", lambda: models["unet"](*unet_args)),
            ("vae_decode", lambda: models["vae"].decode(latents))], models


@torch.no_grad()
def stage_flops(config: dict, height: int, width: int, unet_batch: int,
                prompt_tokens: int = 77) -> Dict[str, float]:
    """FLOPs of each stage of one restore (the UNet: one call)."""
    stages, _ = _stages(config, height, width, unet_batch, prompt_tokens)
    out = {}
    for name, fn in stages:
        with FlopCounterMode(display=False) as counter:
            fn()
        out[name] = float(counter.get_total_flops())
    return out


def restore_flops(config: dict, height: int, width: int, tiles: int,
                  tile_chunk: int, prompt_tokens: int = 77) -> float:
    """FLOPs of one whole restore: encode once, `steps` x the UNet over
    every tile's CFG pair in calls of at most `tile_chunk` tiles, decode."""
    steps = config["pipeline"]["num_inference_steps"]
    total = sum(steps * stage_flops(config, height, width, b, prompt_tokens)["unet"]
                for b in unet_batches(tiles, tile_chunk))
    f = stage_flops(config, height, width, 2, prompt_tokens)
    return total + f["denoise_encoder"] + f["vae_encode"] + f["vae_decode"]


@torch.no_grad()
def group_norm_calls(config: dict, height: int, width: int, unet_batch: int
                     ) -> Dict[str, List[Tuple[tuple, bool, bool]]]:
    """(shape, SiLU, add) of every GroupNorm of each stage (the UNet: one
    call)."""
    stages, models = _stages(config, height, width, unet_batch)
    seen: List[Tuple[tuple, bool, bool]] = []

    def hook(module, args):
        seen.append((tuple(args[0].shape), module.act == "silu",
                     len(args) > 1 and args[1] is not None))

    handles = [m.register_forward_pre_hook(hook)
               for net in models.values() for m in net.modules()
               if isinstance(m, GroupNorm)]
    out = {}
    try:
        for name, fn in stages:
            seen.clear()
            fn()
            out[name] = list(seen)
    finally:
        for h in handles:
            h.remove()
    return out


def group_norm_least_seconds(config: dict, height: int, width: int, tiles: int,
                             tile_chunk: int, esize: int = 2) -> float:
    """Least time of every GroupNorm of one whole restore."""
    def stage_s(calls):
        return sum(least_seconds(*group_norm_work(s, a, d, esize), PEAK_FP32_FLOPS)
                   for s, a, d in calls)

    steps = config["pipeline"]["num_inference_steps"]
    total = sum(steps * stage_s(group_norm_calls(config, height, width, b)["unet"])
                for b in unet_batches(tiles, tile_chunk))
    g = group_norm_calls(config, height, width, 2)
    return total + sum(stage_s(g[k]) for k in ("denoise_encoder", "vae_encode", "vae_decode"))
