"""Model factory: build a wired FaithDiff pipeline (counterpart of
`faithdiff_tpu/pipelines/factory.py`).

Weights come from given state dicts (diffusers / FaithDiff.bin names, e.g.
`utils.convert.state_dict_from_flax` of the JAX package's params, or a
checkpoint read by `utils.safetensors.load_file`) or from a seeded random
init made on the target device. A state dict's tensors may lie on the host
in any float dtype: each loads into the fp32 model, which is then cast to
`dtype` (fp16 -> fp32 -> bf16 rounds to nearest even, as the JAX
package's cast does).

Under `use_fp8` the UNet's weights are stored as float8_e4m3fn, picked
and rounded as the JAX factory picks and rounds them (the compute dtype
first, then fp8; `utils.quantize.quantize_params_fp8`), and each is upcast
to the compute dtype where its layer runs (`models.layers.store_fp8_`),
not the whole UNet once a call. The VAE and the denoise encoder stay in
the compute dtype, as in JAX.

Under `pipeline_config.use_tiled_vae` the denoise encoder, the VAE encode
and the VAE decode run over blended tiles (`models.vae.tiled_apply`) once
the input outgrows a tile, with the JAX factory's gates.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from ..config import (DenoiseEncoderConfig, PipelineConfig, SchedulerConfig,
                      UNetConfig, VAEConfig, tiny_denoise_encoder_config,
                      tiny_unet_config, tiny_vae_config)
from ..models.layers import store_fp8_
from ..models.unet import UNet2DConditionModel
from ..models.vae import AutoencoderKL, DenoiseEncoder, tiled_apply
from ..schedulers import DDPMScheduler, EulerDiscreteScheduler
from ..utils.profiling import span
from ..utils.quantize import quantize_params_fp8
from .faithdiff import FaithDiffPipeline

# zero-initialised like the JAX package's fusion outputs, so an untrained
# fusion path adds nothing
_ZERO_INIT = ("spatial_ch_projs.weight", "condition_embedding.conv_out.weight")


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in place: weight matrices and conv kernels N(0, 1/fan_in)
    (the flax lecun_normal scale), biases 0, norm weights 1, the fusion
    output projections 0."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        elif name.endswith(_ZERO_INIT):
            p.zero_()
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def build_pipeline(
    unet_config: UNetConfig = UNetConfig(),
    vae_config: VAEConfig = VAEConfig(),
    denoise_encoder_config: DenoiseEncoderConfig = DenoiseEncoderConfig(),
    scheduler_config: SchedulerConfig = SchedulerConfig(),
    pipeline_config: PipelineConfig = PipelineConfig(),
    unet_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    vae_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    denoise_encoder_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    seed: int = 0,
    tile_chunk: Optional[int] = None,
    use_fp8: bool = False,
    tile_group=None,
) -> FaithDiffPipeline:
    """Build the pipeline on `device` in `dtype`. Each model loads its state
    dict (strict) or, when it is None, gets `random_init_` from a generator
    seeded with `seed` on the device. `tile_chunk` caps the tiles of one
    UNet call (None: every tile in one call). `use_fp8` stores the UNet's
    weights in fp8 (the module docstring). `tile_group`, a process group,
    splits each UNet call's tiles over its ranks (`FaithDiffPipeline`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_pipeline: device 'cuda' requested but CUDA "
                           "is not available (pass device='cpu' to run on "
                           "the CPU)")
    with span("build_pipeline", use_fp8=use_fp8):
        with device:
            unet = UNet2DConditionModel(unet_config)
            vae = AutoencoderKL(vae_config)
            denoise_encoder = DenoiseEncoder(denoise_encoder_config)
        generator = torch.Generator(device=device).manual_seed(seed)
        for model, state_dict in ((unet, unet_state_dict), (vae, vae_state_dict),
                                  (denoise_encoder, denoise_encoder_state_dict)):
            if state_dict is None:
                random_init_(model, generator)
            else:
                model.load_state_dict(state_dict, strict=True)
            model.to(dtype).eval().requires_grad_(False)
        if use_fp8:
            store_fp8_(unet, quantize_params_fp8(unet.state_dict(), dtype))
        return FaithDiffPipeline(
            unet=unet, vae=vae, denoise_encoder=denoise_encoder,
            scheduler=EulerDiscreteScheduler(scheduler_config),
            ddpm_scheduler=DDPMScheduler(scheduler_config),
            config=pipeline_config,
            vae_scaling_factor=vae_config.scaling_factor,
            tile_chunk=tile_chunk, tile_group=tile_group,
            **_tiled_stages(vae, denoise_encoder, pipeline_config.use_tiled_vae))


def _tiled_stages(vae: AutoencoderKL, denoise_encoder: DenoiseEncoder,
                  use_tiled_vae: bool) -> dict:
    """The pipeline's stage callables: the models' forward passes, or under
    `use_tiled_vae` the tiled ones, taken once the image (or the latents,
    for the decode) is larger than a tile on its longer side."""
    if not use_tiled_vae:
        return {}
    de_tile = denoise_encoder.config.tile_sample_min_size
    de_overlap = denoise_encoder.config.tile_overlap_factor
    tile_sample = vae.config.tile_sample_min_size
    tile_latent = vae.config.tile_latent_min_size
    overlap = vae.config.tile_overlap_factor

    def denoise_encoder_apply(image):
        if max(image.shape[2:]) > de_tile:
            return tiled_apply(denoise_encoder, image, tile_in=de_tile,
                               overlap_factor=de_overlap, scale=1 / 8)
        return denoise_encoder(image)

    def vae_encode_moments(image):
        if max(image.shape[2:]) > tile_sample:
            return tiled_apply(vae.encode_moments, image, tile_in=tile_sample,
                               overlap_factor=overlap, scale=1 / 8)
        return vae.encode_moments(image)

    def vae_decode(latents):
        if max(latents.shape[2:]) > tile_latent:
            return tiled_apply(vae.decode, latents, tile_in=tile_latent,
                               overlap_factor=overlap, scale=8.0)
        return vae.decode(latents)

    return dict(denoise_encoder_apply=denoise_encoder_apply,
                vae_encode_moments=vae_encode_moments, vae_decode=vae_decode)


def build_tiny_pipeline(**kwargs) -> FaithDiffPipeline:
    """Tiny-config pipeline for tests (fp32)."""
    defaults = dict(
        unet_config=tiny_unet_config(),
        vae_config=tiny_vae_config(),
        denoise_encoder_config=tiny_denoise_encoder_config(),
        pipeline_config=PipelineConfig(tile_size=256, num_inference_steps=4),
        dtype=torch.float32,
    )
    defaults.update(kwargs)
    return build_pipeline(**defaults)
