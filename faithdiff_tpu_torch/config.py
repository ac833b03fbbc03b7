"""Configuration dataclasses of the restore and training paths.

The port's own copy of the fields of `faithdiff_tpu/config.py` that the
UNet, VAE, denoise encoder, CLIP text towers, schedulers, pipeline and
trainer read. The defaults are
the full-width SDXL / FaithDiff configuration; `tiny_*_config` are the test
sizes (same topology, small widths).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SDXL UNet (stabilityai/stable-diffusion-xl-base-1.0 `unet/config.json`)
    with the FaithDiff extension slots."""

    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    # diffusers SDXL quirk: this is the head COUNT per block (dim 64 each)
    attention_head_dim: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    addition_embed_type: str = "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_linear_projection: bool = True
    upcast_attention: bool = False
    with_faithdiff_extension: bool = True
    condition_channels: int = 512           # denoise_encoder output channels
    # gradient checkpointing of the fusion stack and of each down / mid /
    # up block in training (`torch.utils.checkpoint`); no forward value
    # changes
    remat: bool = False
    info_transformer_layers: int = 2
    info_transformer_dim: int = 640         # 2 * block_out_channels[0]
    info_transformer_heads: int = 8

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SDXL AutoencoderKL (madebyollin/sdxl-vae-fp16-fix layout)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    act_fn: str = "silu"
    scaling_factor: float = 0.13025
    sample_size: int = 1024
    tile_sample_min_size: int = 1024
    tile_overlap_factor: float = 0.25

    @property
    def tile_latent_min_size(self) -> int:
        return self.tile_sample_min_size // 8


@dataclasses.dataclass(frozen=True)
class DenoiseEncoderConfig:
    """FaithDiff LQ-feature extractor: a VAE encoder without its head."""

    in_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    act_fn: str = "silu"
    mid_block_add_attention: bool = True
    # gradient checkpointing in training: the down blocks per ResNet, the
    # mid block whole
    remat: bool = False
    tile_sample_min_size: int = 1024
    tile_overlap_factor: float = 0.25

    @property
    def out_channels(self) -> int:
        return self.block_out_channels[-1]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """One CLIP text tower of SDXL's prompt encoder."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: Optional[int] = None  # set for text_encoder_2 (bigG)

    @staticmethod
    def sdxl_text_encoder() -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 text tower (SDXL text_encoder)."""
        return CLIPTextConfig()

    @staticmethod
    def sdxl_text_encoder_2() -> "CLIPTextConfig":
        """laion/CLIP-ViT-bigG-14 text tower (SDXL text_encoder_2)."""
        return CLIPTextConfig(
            hidden_size=1280,
            intermediate_size=5120,
            num_hidden_layers=32,
            num_attention_heads=20,
            hidden_act="gelu",
            projection_dim=1280,
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Shared diffusion-process parameters (SDXL scheduler config)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    prediction_type: str = "epsilon"
    # EulerDiscrete extras
    interpolation_type: str = "linear"
    use_karras_sigmas: bool = False
    # DDPM / DDIM extras (the DDPM step's variance is fixed_small)
    clip_sample: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Inference configuration (the reference CLI flags)."""

    num_inference_steps: int = 20
    guidance_scale: float = 5.0
    guidance_rescale: float = 0.0
    tile_size: int = 1024           # pixel-space tile edge (latent = /8)
    tile_overlap: float = 0.5
    start_point: str = "lr"         # "lr" | "noise"
    add_sample: bool = True
    color_fix: str = "wavelet"      # "wavelet" | "adain" | "nofix"
    # VAE encode / decode and the denoise encoder over overlapping tiles of
    # the models' tile_sample_min_size, blended at the seams; the color
    # fix then streams by windows (the CLI's --use_tile_vae)
    use_tiled_vae: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Two-stage training recipe (the reference's `train_stage_1.sh` /
    `train_stage_2.sh`), the fields and defaults of the JAX package's."""

    resolution: int = 512
    batch_size_per_device: int = 16
    # micro-batch gradient accumulation: gradients average over
    # `grad_accum` steps, the optimizer applies at every grad_accum-th
    grad_accum: int = 1
    learning_rate: float = 5e-5
    vis_learning_rate: float = 5e-6  # stage-2 denoise_encoder LR
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 300
    max_train_steps: int = 6000
    noise_offset: float = 0.02
    max_grad_norm: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    ema_decay: float = 0.9999
    ema_update_interval: int = 100
    checkpointing_steps: int = 2000
    checkpoints_total_limit: int = 5
    validation_steps: int = 500
    caption_dropout: float = 0.2
    stage: int = 1
    seed: int = 42


def tiny_unet_config() -> UNetConfig:
    """Small config for tests: same topology, tiny dims."""
    return UNetConfig(
        sample_size=16,
        block_out_channels=(32, 64, 128),
        transformer_layers_per_block=(1, 1, 2),
        attention_head_dim=(4, 8, 16),
        cross_attention_dim=64,
        norm_num_groups=8,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 64,
        condition_channels=64,
        info_transformer_dim=64,
        info_transformer_heads=4,
        info_transformer_layers=2,
    )


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(
        block_out_channels=(16, 32, 32, 32),
        norm_num_groups=8,
        tile_sample_min_size=64,
    )


def tiny_denoise_encoder_config() -> DenoiseEncoderConfig:
    return DenoiseEncoderConfig(
        block_out_channels=(16, 32, 64, 64),
        norm_num_groups=8,
        tile_sample_min_size=64,
    )


def tiny_text_encoder_configs() -> Tuple[CLIPTextConfig, CLIPTextConfig]:
    """The two towers at the JAX CLI's `embed --tiny` sizes: vocab 128,
    width 32, 2 layers, 4 heads; the second projects to 64."""
    tiny = CLIPTextConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4)
    return tiny, dataclasses.replace(tiny, projection_dim=64)
