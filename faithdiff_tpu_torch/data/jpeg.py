"""JPEG compression simulation in PyTorch (counterpart of
`faithdiff_tpu/data/jpeg.py`, basicsr's `DiffJPEG(differentiable=False)`
that the degradation engine uses): JFIF YCbCr, 2x chroma subsampling by
2x2 means, the 8x8 block DCT as two matrix products, the ITU-T T.81
tables scaled by quality and rounded half to even (`torch.round`, as
`jnp.round`), nearest 2x chroma upsampling.

Input and output: [B, H, W, 3] float in [0, 1], H and W multiples of 16
(`pad_to_16`), on any device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

_Q_CHROMA = np.full((8, 8), 99, np.float32)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                     [24, 26, 56, 99], [47, 66, 99, 99]]

_RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], np.float32)
_YCC_TO_RGB = np.array([[1.0, 0.0, 1.402],
                        [1.0, -0.344136, -0.714136],
                        [1.0, 1.772, 0.0]], np.float32)
_YCC_OFFSET = np.array([0.0, 128.0, 128.0], np.float32)


def dct_matrix() -> np.ndarray:
    """The 8x8 DCT-II matrix D: X = D x D^T."""
    k, n = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    d = np.cos(np.pi * k * (2 * n + 1) / 16).astype(np.float32)
    d *= np.sqrt(2.0 / 8.0)
    d[0] /= np.sqrt(2.0)
    return d


def quality_to_factor(quality: torch.Tensor) -> torch.Tensor:
    """JPEG quality (1..100) -> the quantisation tables' scale."""
    quality = quality.float()
    factor = torch.where(quality < 50, 5000.0 / quality, 200.0 - quality * 2.0)
    return factor / 100.0


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/8 * W/8, 8, 8]."""
    b, h, w = x.shape
    x = x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, (h // 8) * (w // 8), 8, 8)


def _from_blocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, h, w)


def _channel_roundtrip(chan: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """DCT, quantise (round half to even), dequantise, inverse DCT of one
    plane [B, H, W] centred on 0; qtable [B, 8, 8]."""
    h, w = chan.shape[1:]
    d = torch.from_numpy(dct_matrix()).to(chan.device)
    coef = d @ _to_blocks(chan) @ d.T
    q = qtable[:, None]
    coef = torch.round(coef / q) * q
    return _from_blocks(d.T @ coef @ d, h, w)


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0, 255] -> JFIF YCbCr in [0, 255]."""
    m = torch.from_numpy(_RGB_TO_YCC).to(x.device)
    return x @ m.T + torch.from_numpy(_YCC_OFFSET).to(x.device)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    m = torch.from_numpy(_YCC_TO_RGB).to(x.device)
    return (x - torch.from_numpy(_YCC_OFFSET).to(x.device)) @ m.T


def jpeg_compress(image: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """One JPEG round trip per sample: image [B, H, W, 3] in [0, 1] with
    H, W % 16 == 0; quality [B] in (0, 100]."""
    b, h, w, _ = image.shape
    factor = quality_to_factor(quality.to(image.device))[:, None, None]
    q_luma = torch.clamp(torch.round(
        torch.from_numpy(_Q_LUMA).to(image.device)[None] * factor), 1, 255)
    q_chroma = torch.clamp(torch.round(
        torch.from_numpy(_Q_CHROMA).to(image.device)[None] * factor), 1, 255)

    x = torch.clamp(image, 0.0, 1.0).float() * 255.0
    ycc = rgb_to_ycbcr(x)
    y = ycc[..., 0] - 128.0
    cb = ycc[..., 1].reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4)) - 128.0
    cr = ycc[..., 2].reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4)) - 128.0

    y = _channel_roundtrip(y, q_luma) + 128.0
    cb = _channel_roundtrip(cb, q_chroma) + 128.0
    cr = _channel_roundtrip(cr, q_chroma) + 128.0
    cb = cb.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr = cr.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    rgb = ycbcr_to_rgb(torch.stack([y, cb, cr], dim=-1))
    return torch.clamp(rgb / 255.0, 0.0, 1.0).to(image.dtype)


def pad_to_16(image: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """Replicate-pad [B, H, W, C] to multiples of 16; returns the padded
    image and the original H, W."""
    h, w = image.shape[1:3]
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    if ph or pw:
        image = F.pad(image.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="replicate").permute(0, 2, 3, 1)
    return image, h, w
