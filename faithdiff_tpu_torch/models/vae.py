"""SDXL AutoencoderKL and the FaithDiff denoise encoder (counterpart of
`faithdiff_tpu/models/vae.py`), NCHW, diffusers state-dict names."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from ..config import DenoiseEncoderConfig, VAEConfig
from .layers import GroupNorm, maybe_checkpoint
from .unet_blocks import DownEncoderBlock2D, UNetMidBlock2D, UpDecoderBlock2D


class Encoder(nn.Module):
    """VAE encoder trunk. `with_head=False` is the FaithDiff denoise
    encoder, which stops at the mid-block output (512 ch at 1/8 res).
    `remat` checkpoints the down blocks per ResNet and the mid block whole
    in training."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 norm_num_groups: int = 32, in_channels: int = 3,
                 with_head: bool = True, mid_block_add_attention: bool = True,
                 remat: bool = False):
        super().__init__()
        ch = list(block_out_channels)
        self.remat = remat
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            self.down_blocks.append(DownEncoderBlock2D(
                cin, cout, layers_per_block, add_downsample=i < len(ch) - 1,
                groups=norm_num_groups, remat=remat))
            cin = cout
        self.mid_block = UNetMidBlock2D(cin, mid_block_add_attention,
                                        norm_num_groups)
        self.with_head = with_head
        if with_head:
            self.conv_norm_out = GroupNorm(norm_num_groups, cin, 1e-6, act="silu")
            self.conv_out = nn.Conv2d(cin, 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x.to(self.conv_in.weight.dtype))
        for block in self.down_blocks:
            x = block(x)
        x = maybe_checkpoint(self.remat, self.mid_block, x)
        if self.with_head:
            x = self.conv_out(self.conv_norm_out(x))
        return x


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 out_channels: int = 3, norm_num_groups: int = 32,
                 mid_block_add_attention: bool = True):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = UNetMidBlock2D(rev[0], mid_block_add_attention,
                                        norm_num_groups)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, cout in enumerate(rev):
            self.up_blocks.append(UpDecoderBlock2D(
                cin, cout, layers_per_block + 1,
                add_upsample=i < len(rev) - 1, groups=norm_num_groups))
            cin = cout
        self.conv_norm_out = GroupNorm(norm_num_groups, cin, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(cin, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z.to(self.conv_in.weight.dtype)))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """KL autoencoder with quant convs."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = Encoder(cfg.block_out_channels, cfg.layers_per_block,
                               cfg.latent_channels, cfg.norm_num_groups,
                               cfg.in_channels)
        self.decoder = Decoder(cfg.block_out_channels, cfg.layers_per_block,
                               cfg.latent_channels, cfg.out_channels,
                               cfg.norm_num_groups)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] image in [-1, 1] -> [B, 8, H/8, W/8] moments."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, 4, h, w] unscaled latents -> [B, 3, 8h, 8w] in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.encode_moments(x).chunk(2, dim=1)
        return self.decode(mean)


def posterior_noise(shape, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """N(0, 1) fp32 noise for the VAE posterior sample, drawn from
    `generator` (a CPU torch.Generator) and moved to `device`."""
    return torch.randn(shape, generator=generator,
                       dtype=torch.float32).to(device)


def sample_from_moments(moments: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample(): mean + std * N(0, 1) in fp32,
    cast back to the moments' dtype; the N(0, 1) draw is `noise` when
    given, else drawn from `generator`. Neither -> the mode."""
    mean, logvar = moments.chunk(2, dim=1)
    if generator is None and noise is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0).float())
    if noise is None:
        noise = posterior_noise(mean.shape, generator, moments.device)
    return (mean.float() + std * noise.to(moments.device)).to(moments.dtype)


# ---------------------------------------------------------------------------
# Tiled application with linear seam blending (diffusers VAE tiling, the
# JAX package's `tiled_apply`). NCHW.
# ---------------------------------------------------------------------------

def blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend the bottom `extent` rows of `a` into the top rows of `b`."""
    extent = min(a.shape[2], b.shape[2], extent)
    if extent <= 0:
        return b
    ramp = (torch.arange(extent, dtype=torch.float32, device=b.device)
            / extent)[:, None]
    top = a[:, :, -extent:].float() * (1 - ramp) + b[:, :, :extent].float() * ramp
    return torch.cat([top.to(b.dtype), b[:, :, extent:]], dim=2)


def blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend the right `extent` columns of `a` into the left columns of `b`."""
    extent = min(a.shape[3], b.shape[3], extent)
    if extent <= 0:
        return b
    ramp = torch.arange(extent, dtype=torch.float32, device=b.device) / extent
    left = (a[:, :, :, -extent:].float() * (1 - ramp)
            + b[:, :, :, :extent].float() * ramp)
    return torch.cat([left.to(b.dtype), b[:, :, :, extent:]], dim=3)


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                tile_in: int, overlap_factor: float, scale: float,
                batched_fn: Optional[Callable] = None,
                batch: int = 0) -> torch.Tensor:
    """Apply `fn` (an image -> feature map with resolution ratio `scale`)
    over overlapping spatial tiles of `x` [B, C, H, W], blending seams
    linearly: stride `tile_in * (1 - overlap)`, blend extent
    `tile_out * overlap`, each tile cropped to `tile_out - extent` before
    the rows and columns are concatenated. Encode is scale 1/8, decode 8.
    Edge tiles are ragged (never padded).

    `batched_fn` ([G, C, th, tw] -> [G, C', oh, ow]) with `batch` > 0 runs
    same-shape tiles `batch` at a time instead (`_tiled_apply_batched`)."""
    overlap_size = int(tile_in * (1 - overlap_factor))
    tile_out = int(round(tile_in * scale))
    blend_extent = int(tile_out * overlap_factor)
    row_limit = tile_out - blend_extent

    h, w = x.shape[2], x.shape[3]
    if batched_fn is not None and batch > 0:
        rows = _tiled_apply_batched(batched_fn, x, tile_in, overlap_size, batch)
    else:
        rows = [[fn(x[:, :, i:i + tile_in, j:j + tile_in])
                 for j in range(0, w, overlap_size)]
                for i in range(0, h, overlap_size)]
    result_rows = []
    for i, row in enumerate(rows):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_v(rows[i - 1][j], tile, blend_extent)
            if j > 0:
                tile = blend_h(row[j - 1], tile, blend_extent)
            result_row.append(tile[:, :, :row_limit, :row_limit])
        result_rows.append(torch.cat(result_row, dim=3))
    return torch.cat(result_rows, dim=2)


def _tiled_apply_batched(batched_fn, x: torch.Tensor, tile_in: int,
                         overlap_size: int, batch: int):
    """`tiled_apply`'s tile grid through `batched_fn` in same-shape groups of
    `batch` tiles (a group padded by repeating its first tiles, whose
    outputs are dropped), as [row][column] outputs."""
    h, w = x.shape[2], x.shape[3]
    grid = [(i // overlap_size, j // overlap_size,
             x[:, :, i:i + tile_in, j:j + tile_in])
            for i in range(0, h, overlap_size)
            for j in range(0, w, overlap_size)]
    n_rows, n_cols = grid[-1][0] + 1, grid[-1][1] + 1
    groups: dict = {}
    for k, (_, _, tile) in enumerate(grid):
        groups.setdefault(tuple(tile.shape[2:]), []).append(k)
    out: dict = {}
    for idxs in groups.values():
        padded = idxs + idxs[:(-len(idxs)) % batch]
        for s in range(0, len(padded), batch):
            sel = padded[s:s + batch]
            res = batched_fn(torch.cat([grid[k][2] for k in sel], dim=0))
            for n, k in enumerate(sel):
                out.setdefault(k, res[n:n + 1])
    return [[out[r * n_cols + c] for c in range(n_cols)] for r in range(n_rows)]


class DenoiseEncoder(Encoder):
    """FaithDiff LQ-feature extractor: the headless VAE encoder. Its state
    dict has the keys of FaithDiff.bin's `denoise_encoder.*` namespace."""

    def __init__(self, config: DenoiseEncoderConfig = DenoiseEncoderConfig()):
        super().__init__(config.block_out_channels, config.layers_per_block,
                         norm_num_groups=config.norm_num_groups,
                         in_channels=config.in_channels, with_head=False,
                         mid_block_add_attention=config.mid_block_add_attention,
                         remat=config.remat)
        self.config = config
