"""SDXL UNet with the FaithDiff LQ-feature fusion path (counterpart of
`faithdiff_tpu/models/unet.py`).

Standard SDXL 2.6B UNet (320/640/1280 channels, transformer depths
[1, 2, 10], text_time added embeddings) with fusion after `conv_in`:
condition embedding over denoise-encoder features, concat ->
information transformer -> zero-init projection -> residual add
(`add_sample=False` replaces instead of adding). NCHW; the state dict
carries diffusers / FaithDiff.bin names.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import UNetConfig
from .adapters import (ConditionEmbedding, ResidualAttentionBlock,
                       information_fusion)
from .layers import (GroupNorm, TimestepEmbedding, get_timestep_embedding,
                     maybe_checkpoint)
from .unet_blocks import (CrossAttnDownBlock2D, CrossAttnUpBlock2D,
                          DownBlock2D, UNetMidBlock2DCrossAttn, UpBlock2D)


class UNet2DConditionModel(nn.Module):
    # the process group whose ranks' batches form one batch in the fusion
    # stack's whole-batch attention (data-parallel training; None: this
    # process's batch)
    fusion_group = None

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        temb = cfg.time_embed_dim
        groups, eps = cfg.norm_num_groups, cfg.norm_eps
        xdim, upcast = cfg.cross_attention_dim, cfg.upcast_attention

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, temb)
        if cfg.with_faithdiff_extension:
            self.condition_embedding = ConditionEmbedding(
                cfg.condition_channels, ch[0])
            self.information_transformer_layes = nn.ModuleList([
                ResidualAttentionBlock(cfg.info_transformer_dim,
                                       cfg.info_transformer_heads)
                for _ in range(cfg.info_transformer_layers)])
            self.spatial_ch_projs = nn.Linear(cfg.info_transformer_dim, ch[0])
            nn.init.zeros_(self.spatial_ch_projs.weight)
            nn.init.zeros_(self.spatial_ch_projs.bias)

        self.down_blocks = nn.ModuleList()
        skips = [ch[0]]                      # channels of each down output
        cin = ch[0]
        n = len(ch)
        for i, block_type in enumerate(cfg.down_block_types):
            final = i == n - 1
            if block_type == "CrossAttnDownBlock2D":
                # diffusers SDXL quirk: `attention_head_dim` is the head COUNT
                block = CrossAttnDownBlock2D(
                    cin, ch[i], temb, cfg.attention_head_dim[i],
                    cfg.transformer_layers_per_block[i], xdim,
                    cfg.layers_per_block, not final, groups, eps, upcast)
            else:
                block = DownBlock2D(cin, ch[i], temb, cfg.layers_per_block,
                                    not final, groups, eps)
            self.down_blocks.append(block)
            skips += [ch[i]] * cfg.layers_per_block + ([] if final else [ch[i]])
            cin = ch[i]

        self.mid_block = UNetMidBlock2DCrossAttn(
            ch[-1], temb, cfg.attention_head_dim[-1],
            cfg.transformer_layers_per_block[-1], xdim, groups, eps, upcast)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        prev = ch[-1]
        for i, block_type in enumerate(cfg.up_block_types):
            final = i == len(cfg.up_block_types) - 1
            n_layers = cfg.layers_per_block + 1
            block_skips = [skips.pop() for _ in range(n_layers)]
            rev_idx = n - 1 - i
            if block_type == "CrossAttnUpBlock2D":
                block = CrossAttnUpBlock2D(
                    prev, rev[i], block_skips, temb,
                    cfg.attention_head_dim[rev_idx],
                    cfg.transformer_layers_per_block[rev_idx], xdim,
                    not final, groups, eps, upcast)
            else:
                block = UpBlock2D(prev, rev[i], block_skips, temb, not final,
                                  groups, eps)
            self.up_blocks.append(block)
            prev = rev[i]

        self.conv_norm_out = GroupNorm(groups, ch[0], eps, act="silu")
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_text_embeds: torch.Tensor,
                added_time_ids: torch.Tensor,
                input_embedding: Optional[torch.Tensor] = None,
                add_sample: bool = True,
                fusion_group_size: Optional[int] = None) -> torch.Tensor:
        """sample [B, 4, H, W] noisy latents; timestep scalar or [B];
        encoder_hidden_states [B, 77, 2048]; added_text_embeds [B, 1280];
        added_time_ids [B, 6]; input_embedding [B, 512, H, W] LQ features.
        Returns eps [B, 4, H, W]."""
        cfg = self.config
        # the bias's: an fp8-stored weight is upcast at every read
        dtype = self.conv_in.bias.dtype
        b = sample.shape[0]
        timestep = torch.as_tensor(timestep, device=sample.device)
        if timestep.ndim == 0:
            timestep = timestep.expand(b)
        t_emb = get_timestep_embedding(
            timestep, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
            cfg.freq_shift).to(dtype)
        emb = self.time_embedding(t_emb)
        if cfg.addition_embed_type == "text_time":
            time_embeds = get_timestep_embedding(
                added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift).reshape(b, -1)
            add_embeds = torch.cat([added_text_embeds.float(), time_embeds],
                                   dim=-1).to(dtype)
            emb = emb + self.add_embedding(add_embeds)
        context = encoder_hidden_states.to(dtype)

        sample = self.conv_in(sample.to(dtype))
        if cfg.with_faithdiff_extension and input_embedding is not None:
            cond = self.condition_embedding(input_embedding.to(dtype))
            # under remat the fusion stack and each block are checkpointed,
            # as the JAX model's nn.remat does
            feat_alpha = maybe_checkpoint(
                cfg.remat, information_fusion,
                self.information_transformer_layes, self.spatial_ch_projs,
                sample, cond, fusion_group_size, self.fusion_group)
            sample = sample + feat_alpha if add_sample else feat_alpha

        down_res = [sample]
        for block in self.down_blocks:
            sample, res = maybe_checkpoint(cfg.remat, block, sample, emb,
                                           context)
            down_res += res

        sample = maybe_checkpoint(cfg.remat, self.mid_block, sample, emb,
                                  context)

        n_layers = cfg.layers_per_block + 1
        for block in self.up_blocks:
            res = down_res[-n_layers:]
            down_res = down_res[:-n_layers]
            upsample_size = down_res[-1].shape[2:] if down_res else None
            sample = maybe_checkpoint(cfg.remat, block, sample, res, emb,
                                      context, upsample_size)

        return self.conv_out(self.conv_norm_out(sample))
