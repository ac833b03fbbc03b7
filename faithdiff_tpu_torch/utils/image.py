"""Image size and value-range helpers and the HDR (Mertens exposure fusion)
effect (counterpart of `faithdiff_tpu/utils/image.py`). The fusion runs
in torch, fp32, on the caller's device; HWC uint8 in and out."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def check_image_size(
    img: np.ndarray, padder_size: int = 8
) -> Tuple[np.ndarray, int, int, int, int]:
    """Replicate-pad an HWC image (bottom / right) to a multiple of
    `padder_size`. Returns (padded, width, height, padded_width,
    padded_height)."""
    height, width = img.shape[:2]
    mod_pad_h = (padder_size - height % padder_size) % padder_size
    mod_pad_w = (padder_size - width % padder_size) % padder_size
    padded = np.pad(
        img, ((0, mod_pad_h), (0, mod_pad_w)) + ((0, 0),) * (img.ndim - 2),
        mode="edge",
    )
    return padded, width, height, width + mod_pad_w, height + mod_pad_h


def image_to_array(img: np.ndarray) -> np.ndarray:
    """HWC (or HW) uint8 -> [1, H, W, C] float32 in [0, 1]."""
    if img.ndim == 2:
        img = img[:, :, None]
    return (img.astype(np.float32) / 255.0)[None]


def array_to_image(x: np.ndarray) -> np.ndarray:
    """[..., H, W, C] float in [0, 1] (leading dims of 1) -> HWC uint8."""
    x = np.asarray(x, dtype=np.float32)
    while x.ndim > 3:
        x = x[0]
    x = np.clip(x, 0.0, 1.0)
    return np.uint8(np.round(x * 255.0))


def normalize_to_diffusion(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def denormalize_from_diffusion(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# HDR effect: Mertens exposure fusion over 9 synthetic exposures. NCHW.
# ---------------------------------------------------------------------------

def _blur5(x: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur ([1, 4, 6, 4, 1] / 16 outer), reflect padding,
    depthwise. x: [B, C, H, W]."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device) / 16.0
    c = x.shape[1]
    kern = torch.outer(k, k).expand(c, 1, 5, 5)
    return F.conv2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), kern, groups=c)


def _downsample(x: torch.Tensor) -> torch.Tensor:
    return _blur5(x)[:, :, ::2, ::2]


def _upsample(x: torch.Tensor, shape_hw: Tuple[int, int]) -> torch.Tensor:
    b, c, h, w = x.shape
    up = torch.zeros((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    up[:, :, ::2, ::2] = x
    return (_blur5(up) * 4.0)[:, :, :shape_hw[0], :shape_hw[1]]


def _pyramid_levels(h: int, w: int, max_levels: int = 8) -> int:
    lv = 1
    while min(h, w) >= 16 and lv < max_levels:
        h, w = (h + 1) // 2, (w + 1) // 2
        lv += 1
    return lv


def mertens_fusion(images: torch.Tensor, contrast_w: float = 1.0,
                   sat_w: float = 1.0, expo_w: float = 1.0) -> torch.Tensor:
    """Exposure fusion (Mertens et al. 2007) of [N, 3, H, W] float images in
    [0, 1] -> [3, H, W] in [0, 1]: quality weights (contrast, saturation,
    well-exposedness), then a Laplacian-pyramid blend."""
    n, _, h, w = images.shape
    luma = torch.tensor([0.299, 0.587, 0.114], device=images.device)
    gray = torch.einsum("nchw,c->nhw", images, luma)
    lap_k = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                         device=images.device)
    contrast = F.conv2d(F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect"),
                        lap_k[None, None])[:, 0].abs()
    mean_c = images.mean(dim=1)
    sat = torch.sqrt((images - mean_c[:, None]).square().mean(dim=1))
    expo = torch.prod(torch.exp(-((images - 0.5) ** 2) / (2 * 0.2 ** 2)), dim=1)

    weights = ((contrast + 1e-12) ** contrast_w * (sat + 1e-12) ** sat_w
               * (expo + 1e-12) ** expo_w) + 1e-12
    weights = weights / weights.sum(dim=0, keepdim=True)          # [N, H, W]

    levels = _pyramid_levels(h, w)
    w_pyr = [weights[:, None]]
    img_gauss = [images]
    for _ in range(levels - 1):
        w_pyr.append(_downsample(w_pyr[-1]))
        img_gauss.append(_downsample(img_gauss[-1]))
    img_lap = [img_gauss[lv] - _upsample(img_gauss[lv + 1],
                                         img_gauss[lv].shape[2:])
               for lv in range(levels - 1)] + [img_gauss[-1]]
    blended = [(img_lap[lv] * w_pyr[lv]).sum(dim=0, keepdim=True)
               for lv in range(levels)]
    out = blended[-1]
    for lv in range(levels - 2, -1, -1):
        out = _upsample(out, blended[lv].shape[2:]) + blended[lv]
    return out[0].clamp(0.0, 1.0)


@torch.no_grad()
def create_hdr_effect(image: np.ndarray, hdr: float,
                      device="cuda") -> np.ndarray:
    """HDR effect over 9 scaled exposures of an HWC uint8 image, fused on
    `device`; hdr in [0, 1]; returns HWC uint8 (truncated, as the JAX
    package's `np.uint8` cast does)."""
    if hdr == 0:
        return image
    factors = [
        1.0 - 0.9 * hdr, 1.0 - 0.7 * hdr, 1.0 - 0.45 * hdr, 1.0 - 0.25 * hdr,
        1.0, 1.0 + 0.2 * hdr, 1.0 + 0.4 * hdr, 1.0 + 0.6 * hdr, 1.0 + 0.8 * hdr,
    ]
    base = torch.as_tensor(np.asarray(image), device=device).permute(2, 0, 1).float()
    exposures = torch.stack([torch.clamp(base * f, 0, 255) / 255.0
                             for f in factors])
    fused = mertens_fusion(exposures)
    out = torch.clamp(fused * 255.0, 0, 255).to(torch.uint8)
    return out.permute(1, 2, 0).cpu().numpy()
