"""The FaithDiff tiled restoration pipeline (counterpart of
`faithdiff_tpu/pipelines/faithdiff.py`).

denoise encoder LQ features -> VAE encode + DDPM noise to t=999 (or pure
noise) -> Euler loop over Gaussian-blended latent tiles, the tiles' CFG
pairs in UNet calls of at most `tile_chunk` tiles ([neg_0, pos_0, neg_1,
pos_1, ...], fusion group size 2) -> VAE decode -> color fix. Above
`tile_chunk` tiles the LQ feature map stays unsplit and each chunk's
tiles are cut from it in the loop; the last chunk may be ragged (the JAX
package pads it, and its padded tiles never reach the merge). Above
`host_loop_tile_threshold` tiles a `checkpoint_dir` keeps each step's
canvas, from which a re-run with the same inputs resumes. Under
`config.use_tiled_vae` the factory's stages run the denoise encoder and
the VAE over blended tiles, and the color fix streams by windows into a
host canvas. Public layouts follow the JAX package: a [H, W, 3] uint8 or
float input, NHWC latents in and out; the models run NCHW inside. `seed`
drives torch.Generators.

With a `tile_group` (a `torch.distributed` process group of N ranks, the
JAX package's `tile_sharding` over N devices) the tiles are padded as JAX
pads them, by repeating tiles `idx % num_tiles` up to a multiple of N, or
of `tile_chunk` above one chunk (`tile_chunk` must be a multiple of N);
each rank runs the UNet on its N-th of each chunk's rows, the chunk's eps
are all-gathered, and the padded rows never reach the merge, so every
rank holds the same canvas. Everything else runs on every rank.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..models.unet import UNet2DConditionModel
from ..models.vae import AutoencoderKL, DenoiseEncoder, sample_from_moments
from ..schedulers import DDPMScheduler, EulerDiscreteScheduler
from ..utils.color_fix import (adain_color_fix, streaming_color_fix,
                               wavelet_color_fix)
from ..utils.image import denormalize_from_diffusion, normalize_to_diffusion
from ..utils.profiling import span
from .tiling import (compute_tile_layout, gaussian_tile_weights, merge_tiles,
                     split_tiles, tile_position_ids)


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """CFG rescale, with the JAX package's population std (ddof 0)."""
    dims = tuple(range(1, noise_pred_text.ndim))
    std_text = noise_pred_text.std(dim=dims, correction=0, keepdim=True)
    std_cfg = noise_cfg.std(dim=dims, correction=0, keepdim=True)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def _canvas_ckpt_load(ckpt_dir: str, meta: dict):
    """`(next_step, latents)` from the newest per-step canvas under
    `ckpt_dir` whose run metadata matches `meta`, else None. The canvas
    after the last step resumes straight into decode: a crash between the
    last step and the decode does not denoise again."""
    meta_path = os.path.join(ckpt_dir, "canvas_meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        if json.load(f) != meta:
            return None
    steps = [int(name[len("canvas_step"):-len(".npy")])
             for name in os.listdir(ckpt_dir)
             if name.startswith("canvas_step") and name.endswith(".npy")]
    if not steps:
        return None
    best = max(steps)
    return best + 1, np.load(os.path.join(ckpt_dir, f"canvas_step{best:04d}.npy"))


def _canvas_ckpt_save(ckpt_dir: str, meta: dict, step: int,
                      latents: np.ndarray) -> None:
    """Write the canvas after `step` (NHWC fp32, as the JAX package writes
    it) and the run metadata, each by an atomic rename. A new metadata
    drops the canvases of the previous run first."""
    os.makedirs(ckpt_dir, exist_ok=True)
    meta_path = os.path.join(ckpt_dir, "canvas_meta.json")
    stale = True
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            stale = json.load(f) != meta
    if stale:
        for name in os.listdir(ckpt_dir):
            if name.startswith("canvas_step") and name.endswith(".npy"):
                os.remove(os.path.join(ckpt_dir, name))
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(meta_path + ".tmp", meta_path)
    path = os.path.join(ckpt_dir, f"canvas_step{step:04d}.npy")
    np.save(path + ".tmp.npy", latents)
    os.replace(path + ".tmp.npy", path)


def _host_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _content_hash(*tensors) -> str:
    """Hash of tensor shapes, dtypes and contents: a resume must match a
    run with the same conditioning and the same initial latents."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        h.update(_host_bytes(t))
    return h.hexdigest()[:16]


def _params_fingerprint(module: torch.nn.Module) -> str:
    """Weight identity without hashing gigabytes: the state dict's names,
    shapes and dtypes plus the bytes of its smallest tensor."""
    sd = module.state_dict()
    h = hashlib.sha256()
    h.update(str([(k, tuple(v.shape), str(v.dtype))
                  for k, v in sd.items()]).encode())
    if sd:
        h.update(_host_bytes(min(sd.values(), key=lambda v: v.numel())))
    return h.hexdigest()[:16]


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


@dataclasses.dataclass
class FaithDiffPipeline:
    """Denoise encoder -> tiled UNet denoising -> VAE decode. The models'
    parameters decide the device and the compute dtype. The three stage
    callables (NCHW in and out) default to the models' own forward passes;
    `pipelines.factory.build_pipeline` gives the tiled ones."""

    unet: UNet2DConditionModel
    vae: AutoencoderKL
    denoise_encoder: DenoiseEncoder
    scheduler: EulerDiscreteScheduler = dataclasses.field(
        default_factory=EulerDiscreteScheduler)
    ddpm_scheduler: DDPMScheduler = dataclasses.field(
        default_factory=DDPMScheduler)
    config: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    vae_scaling_factor: float = 0.13025
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None
    # tiles per UNet call; above it the LQ feature map stays unsplit
    tile_chunk: Optional[int] = None
    # ranks that split each UNet call's tiles (None: this process alone)
    tile_group: Optional[dist.ProcessGroup] = None
    # above this tile count a checkpoint_dir keeps every step's canvas
    host_loop_tile_threshold: int = 16
    # image [1, 3, H, W] -> LQ features / VAE moments; latents -> image
    denoise_encoder_apply: Optional[Callable] = None
    vae_encode_moments: Optional[Callable] = None
    vae_decode: Optional[Callable] = None

    def __post_init__(self):
        if self.denoise_encoder_apply is None:
            self.denoise_encoder_apply = self.denoise_encoder
        if self.vae_encode_moments is None:
            self.vae_encode_moments = self.vae.encode_moments
        if self.vae_decode is None:
            self.vae_decode = self.vae.decode

    # from the bias: an fp8-stored weight is upcast at every read
    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.bias.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.bias.dtype

    def _denormalize_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> the VAE's latent space."""
        if self.latents_mean is not None and self.latents_std is not None:
            mean = torch.tensor(self.latents_mean, dtype=torch.float32,
                                device=latents.device).reshape(1, -1, 1, 1)
            std = torch.tensor(self.latents_std, dtype=torch.float32,
                               device=latents.device).reshape(1, -1, 1, 1)
            return latents * std / self.vae_scaling_factor + mean
        return latents / self.vae_scaling_factor

    @staticmethod
    def _prep_input(src: torch.Tensor) -> torch.Tensor:
        """[H, W, 3] uint8 or float [0, 1] -> [1, 3, H, W] fp32 in [-1, 1]."""
        x = src.float() / 255.0 if src.dtype == torch.uint8 else src.float()
        return normalize_to_diffusion(x.permute(2, 0, 1)[None].contiguous())

    @torch.no_grad()
    def __call__(
        self,
        lr_image: np.ndarray,                  # [H, W, 3] float [0,1] or uint8
        prompt_embeds,                         # [1, 77*, 2048] positive
        pooled_prompt_embeds,                  # [1, 1280]
        negative_prompt_embeds=None,
        negative_pooled_prompt_embeds=None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        guidance_rescale: Optional[float] = None,
        overlap: Optional[float] = None,
        start_point: Optional[str] = None,
        add_sample: Optional[bool] = None,
        color_fix: Optional[str] = None,
        seed: int = 0,
        latents=None,                          # [1, H/8, W/8, 4] NHWC
        output_type: str = "np",   # "np" float [0,1] | "uint8" | "latent"
        noise_source: str = "torch",
        checkpoint_dir: Optional[str] = None,
    ):
        cfg = self.config
        steps = num_inference_steps or cfg.num_inference_steps
        guidance_scale = (cfg.guidance_scale if guidance_scale is None
                          else guidance_scale)
        guidance_rescale = (cfg.guidance_rescale if guidance_rescale is None
                            else guidance_rescale)
        overlap = cfg.tile_overlap if overlap is None else overlap
        start_point = start_point or cfg.start_point
        add_sample = cfg.add_sample if add_sample is None else add_sample
        if noise_source != "torch":
            raise ValueError("noise_source must be 'torch': the port draws "
                             "its noise from torch.Generators")
        if output_type not in ("np", "uint8", "latent"):
            raise ValueError(f"unknown output_type {output_type!r}")

        h, w = lr_image.shape[:2]
        if h % 8 or w % 8:
            raise ValueError(f"input must be /8-padded; got {h}x{w}")
        lh, lw = h // 8, w // 8
        tile_k = (min(cfg.tile_size // 8, lh), min(cfg.tile_size // 8, lw))
        layout = compute_tile_layout(lh, lw, tile_k, overlap)
        dev = self.device

        # the LQ features are cut into the tile grid up front only when
        # every tile runs in one UNet call
        n = layout.num_tiles
        lazy = self.tile_chunk is not None and n > self.tile_chunk
        n_pad, devices, rank = n, 1, 0
        if self.tile_group is not None:
            devices = dist.get_world_size(self.tile_group)
            rank = dist.get_rank(self.tile_group)
            pad_base = devices
            if self.tile_chunk:
                if self.tile_chunk % devices:
                    raise ValueError(f"tile_chunk {self.tile_chunk} is not a "
                                     f"multiple of {devices} tile devices")
                if lazy:
                    pad_base = self.tile_chunk
            n_pad = n + (-n) % pad_base
        # the padded tile list: tile t of it is tile idx[t] of the layout
        idx = np.arange(n_pad) % n
        chunk = n_pad if self.tile_chunk is None else min(self.tile_chunk, n_pad)

        with span("restore", h=h, w=w, tiles=n, chunk=chunk, steps=steps):
            with span("encode"):
                src = torch.as_tensor(np.asarray(lr_image), device=dev)   # one upload
                image = self._prep_input(src)
                # LQ features of the whole image
                image_latents = self.denoise_encoder_apply(image)
                lq_tiles = None if lazy else split_tiles(image_latents, layout)

                # initial latents: NCHW noise from a CPU generator
                # (bit-identical to diffusers' randn_tensor); the same
                # generator then draws the VAE posterior noise
                state = self.scheduler.set_timesteps(steps)
                gen = torch.Generator().manual_seed(seed)
                noise = torch.randn((1, 4, lh, lw), generator=gen)
                if latents is None:
                    latents = noise.to(dev)
                else:
                    latents = _tensor(latents, dev).permute(0, 3, 1, 2).contiguous()
                latents = latents * state.init_noise_sigma
                if start_point == "lr":
                    moments = self.vae_encode_moments(image)
                    lr_latents = sample_from_moments(moments, gen).float() \
                        * self.vae_scaling_factor
                    latents = self.ddpm_scheduler.add_noise(lr_latents, latents, [999])

                # negative embeds default to zeros (force_zeros_for_empty_prompt)
                prompt_embeds = _tensor(prompt_embeds, dev)
                pooled_prompt_embeds = _tensor(pooled_prompt_embeds, dev)
                neg = (torch.zeros_like(prompt_embeds) if negative_prompt_embeds is None
                       else _tensor(negative_prompt_embeds, dev))
                neg_pooled = (torch.zeros_like(pooled_prompt_embeds)
                              if negative_pooled_prompt_embeds is None
                              else _tensor(negative_pooled_prompt_embeds, dev))
                embeds = torch.cat([neg, prompt_embeds], dim=0)
                pooled = torch.cat([neg_pooled, pooled_prompt_embeds], dim=0)

                # per-tile add_time_ids: [orig (h, w), latent offset (i, j), target]
                pos = tile_position_ids(layout).astype(np.float32)
                size = np.tile(np.asarray((h, w), np.float32), (n, 1))
                time_ids = torch.from_numpy(
                    np.concatenate([size, pos, size], axis=1)).to(dev)

                # per-call constants at chunk size; a ragged last chunk takes
                # a prefix
                ctx_c = embeds.repeat(chunk, 1, 1)
                pooled_c = pooled.repeat(chunk, 1)
                weights = torch.from_numpy(gaussian_tile_weights(*layout.kernel)).to(dev)

            def unet_chunk(tiles, i, lo):
                """One UNet call over padded tiles [lo, lo + chunk): each
                tile's CFG pair adjacent, tile-major. Under a tile group
                this rank runs its share of the rows and the chunk's eps
                are gathered."""
                hi = min(lo + chunk, n_pad)
                per = (hi - lo) // devices
                lo, hi = lo + rank * per, lo + (rank + 1) * per
                # a slice where no tile repeats (every tile of a process alone)
                sel = slice(lo, hi) if hi <= n else torch.from_numpy(idx[lo:hi])
                if lq_tiles is None:
                    lq = split_tiles(image_latents, dataclasses.replace(
                        layout, offsets=tuple(layout.offsets[t] for t in idx[lo:hi])))
                else:
                    lq = lq_tiles[sel]
                rows = 2 * (hi - lo)
                model_in = self.scheduler.scale_model_input(
                    state, tiles[sel].repeat_interleave(2, dim=0), i)
                with span("unet", rows=rows):
                    eps = self.unet(model_in, state.timesteps[i], ctx_c[:rows],
                                    pooled_c[:rows],
                                    time_ids[sel].repeat_interleave(2, dim=0),
                                    lq.repeat_interleave(2, dim=0),
                                    add_sample=add_sample, fusion_group_size=2)
                    if self.tile_group is None:
                        return eps
                    parts = [torch.empty_like(eps) for _ in range(devices)]
                    dist.all_gather(parts, eps.contiguous(), group=self.tile_group)
                    return torch.cat(parts)

            start = 0
            ck_meta = None
            if checkpoint_dir is not None and n > self.host_loop_tile_threshold:
                ck_meta = {
                    "seed": int(seed), "h": int(h), "w": int(w),
                    "steps": int(steps), "overlap": float(overlap),
                    "guidance": float(guidance_scale),
                    "rescale": float(guidance_rescale),
                    "noise_source": noise_source, "start_point": start_point,
                    "add_sample": bool(add_sample),
                    # a new caption, caller latents or weights start afresh
                    "cond_hash": _content_hash(embeds, pooled),
                    "init_latents_hash": _content_hash(
                        latents.permute(0, 2, 3, 1).contiguous()),
                    "params_fp": _params_fingerprint(self.unet),
                }
                resumed = _canvas_ckpt_load(checkpoint_dir, ck_meta)
                if resumed is not None:
                    start, canvas = resumed
                    latents = torch.from_numpy(canvas).to(dev).permute(
                        0, 3, 1, 2).contiguous()
            elif checkpoint_dir is not None:
                warnings.warn(
                    f"checkpoint_dir is ignored at {n} tiles <= "
                    f"host_loop_tile_threshold={self.host_loop_tile_threshold}: "
                    "as in the JAX package, only runs above it keep per-step "
                    "canvases to resume from.", stacklevel=2)

            for i in range(start, steps):
                with span("step", i=i):
                    tiles = split_tiles(latents, layout)
                    # the padded tiles' rows are dropped before the merge
                    eps = torch.cat([unet_chunk(tiles, i, lo)
                                     for lo in range(0, n_pad, chunk)])[:2 * n]
                    eps = eps.reshape(n, 2, *eps.shape[1:])
                    eps_uncond, eps_text = eps[:, 0], eps[:, 1]
                    eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
                    if guidance_rescale > 0.0:
                        eps = rescale_noise_cfg(eps, eps_text, guidance_rescale)
                    tiles = self.scheduler.step(state, eps, i, tiles)
                    latents = merge_tiles(tiles, layout, weights)
                    if ck_meta is not None and rank == 0:     # one writer a group
                        _canvas_ckpt_save(checkpoint_dir, ck_meta, i, latents.permute(
                            0, 2, 3, 1).float().cpu().numpy())
            del lq_tiles, image_latents

            if output_type == "latent":
                return latents.permute(0, 2, 3, 1).contiguous()
            with span("decode"):
                return self._decode(latents, src, color_fix, output_type == "uint8")

    @torch.no_grad()
    def decode(self, latents, lr_image, color_fix: Optional[str] = None,
               output_type: str = "np") -> np.ndarray:
        """NHWC latents (as `output_type="latent"` returns them) and the
        [H, W, 3] input -> the restored [H, W, 3] image, float [0, 1]
        ("np") or "uint8"."""
        if output_type not in ("np", "uint8"):
            raise ValueError(f"unknown output_type {output_type!r}")
        dev = self.device
        with span("decode"):
            src = torch.as_tensor(np.asarray(lr_image), device=dev)
            latents = _tensor(latents, dev).permute(0, 3, 1, 2).contiguous()
            return self._decode(latents, src, color_fix, output_type == "uint8")

    def _decode(self, latents: torch.Tensor, src: torch.Tensor,
                color_fix: Optional[str], to_uint8: bool) -> np.ndarray:
        color_fix = self.config.color_fix if color_fix is None else color_fix
        image_out = self.vae_decode(self._denormalize_latents(latents))
        if self.config.use_tiled_vae:
            # the fix streams window by window into a host canvas: the
            # one-shot fix holds ~10 full-resolution buffers on the device
            return streaming_color_fix(image_out, src, mode=color_fix,
                                       to_uint8=to_uint8, denorm=True)
        # the color transfer stays in the decode dtype (as in JAX, where
        # fp32 doubles ~10 full-resolution buffers)
        image_out = denormalize_from_diffusion(image_out)
        src = src.float() / 255.0 if src.dtype == torch.uint8 else src
        src = src.permute(2, 0, 1)[None].to(image_out.dtype)
        if color_fix == "wavelet":
            image_out = wavelet_color_fix(image_out, src)
        elif color_fix == "adain":
            image_out = adain_color_fix(image_out, src)
        elif color_fix != "nofix":
            raise ValueError(f"unknown color_fix {color_fix!r}")
        if to_uint8:
            image_out = torch.round(
                torch.clamp(image_out, 0.0, 1.0).float() * 255.0).to(torch.uint8)
        else:
            image_out = image_out.float()
        return image_out[0].permute(1, 2, 0).cpu().numpy()
