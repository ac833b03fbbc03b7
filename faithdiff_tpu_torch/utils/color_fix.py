"""Wavelet / AdaIN color correction (counterpart of
`faithdiff_tpu/utils/color_fix.py`): transfer the low-frequency content of
the LQ source onto the restored output. NCHW, values in [0, 1]; the work
stays in the caller's dtype (the decode dtype on the card)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_WAVELET_KERNEL = ((0.0625, 0.125, 0.0625),
                   (0.125, 0.25, 0.125),
                   (0.0625, 0.125, 0.0625))


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Depthwise dilated 3x3 low-pass with replicate padding, computed in
    fp32 and returned in the input dtype. image: [B, C, H, W]."""
    c = image.shape[1]
    kernel = torch.tensor(_WAVELET_KERNEL, dtype=torch.float32,
                          device=image.device).expand(c, 1, 3, 3)
    padded = F.pad(image.float(), (radius,) * 4, mode="replicate")
    return F.conv2d(padded, kernel, dilation=radius, groups=c).to(image.dtype)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    """(high_freq, low_freq) over `levels` octaves."""
    high_freq = torch.zeros_like(image)
    low_freq = image
    for i in range(levels):
        low_freq = wavelet_blur(image, 2 ** i)
        high_freq = high_freq + (image - low_freq)
        image = low_freq
    return high_freq, low_freq


def wavelet_reconstruction(content: torch.Tensor,
                           style: torch.Tensor) -> torch.Tensor:
    """content's high frequencies + style's low frequencies."""
    content_high, _ = wavelet_decomposition(content)
    _, style_low = wavelet_decomposition(style)
    return content_high + style_low


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5):
    """Per-channel spatial mean and std (unbiased variance) of [B, C, H, W]."""
    b, c = feat.shape[:2]
    flat = feat.reshape(b, c, -1)
    mean = flat.mean(dim=2, keepdim=True)
    n = flat.shape[2]
    var = (flat - mean).square().sum(dim=2, keepdim=True) / max(n - 1, 1)
    return mean.reshape(b, c, 1, 1), torch.sqrt(var + eps).reshape(b, c, 1, 1)


def adaptive_instance_normalization(content: torch.Tensor,
                                    style: torch.Tensor) -> torch.Tensor:
    style_mean, style_std = calc_mean_std(style)
    content_mean, content_std = calc_mean_std(content)
    return (content - content_mean) / content_std * style_std + style_mean


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    return torch.clamp(wavelet_reconstruction(target, source), 0.0, 1.0)


def adain_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    return torch.clamp(adaptive_instance_normalization(target, source), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Streaming color fix: window by window into a host canvas, so the device
# holds one (tile + 2 * halo) window at a time, not ~10 full-resolution
# buffers. The wavelet transfer is local: 5 dilated 3x3 levels reach
# sum(2^i, i < 5) = 31 px, so a 32-px halo gives every kept pixel the
# full-image result (replicate padding lands only in the discarded halo or
# on a true image edge, where the full-image op replicates too). AdaIN
# needs only global per-channel moments, which are exact sums.
# ---------------------------------------------------------------------------

_HALO = 32


def _as_01(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> fp32 in [0, 1]; float passes through."""
    return x.float() / 255.0 if x.dtype == torch.uint8 else x


def _window_fix(target: torch.Tensor, source: torch.Tensor, mode: str,
                to_uint8: bool, denorm: bool, win, crop, stats):
    """The fix of one window: target [C, H, W] (decode dtype), source
    [H, W, C]; `win` = (y, x, h, w) of the window, `crop` = (y, x, h, w) of
    the part kept, relative to it."""
    wy, wx, wh, ww = win
    oy, ox, ch, cw = crop
    tgt = target[:, wy:wy + wh, wx:wx + ww]
    src = _as_01(source[wy:wy + wh, wx:wx + ww]).permute(2, 0, 1)
    if denorm:
        tgt = torch.clamp(tgt / 2.0 + 0.5, 0.0, 1.0)
    if mode == "wavelet":
        high, _ = wavelet_decomposition(tgt[None])
        _, low = wavelet_decomposition(src[None].to(tgt.dtype))
        out = torch.clamp(high + low, 0.0, 1.0)[0]
    else:
        t_mean, t_std, s_mean, s_std = stats
        out = torch.clamp((tgt.float() - t_mean) / t_std * s_std + s_mean,
                          0.0, 1.0)
    out = out[:, oy:oy + ch, ox:ox + cw]
    if to_uint8:
        return torch.round(out.float() * 255.0).to(torch.uint8)
    return out.float()


def _moments(x: torch.Tensor, denorm: bool, dims):
    """Per-channel fp32 sum and sum of squares over `dims`."""
    xf = _as_01(x).float()
    if denorm:
        xf = torch.clamp(xf / 2.0 + 0.5, 0.0, 1.0)
    return xf.sum(dim=dims), xf.square().sum(dim=dims)


@torch.no_grad()
def streaming_color_fix(target: torch.Tensor, source: torch.Tensor,
                        mode: str = "wavelet", tile: int = 2048,
                        to_uint8: bool = False,
                        denorm: bool = False) -> np.ndarray:
    """Tile-streamed color fix assembled in a host canvas.

    target: [1, C, H, W] on the device, in the decode dtype (in [-1, 1]
    when `denorm`, else [0, 1]); source: [H, W, C] uint8 or float [0, 1] on
    the same device. Returns [H, W, C] uint8 (`to_uint8`) or float32. The
    wavelet mode equals `wavelet_color_fix` on every pixel, AdaIN uses the
    exact global moments, "nofix" only crops and quantizes."""
    if mode not in ("wavelet", "adain", "nofix"):
        raise ValueError(f"unknown color_fix {mode!r}")
    _, c, h, w = target.shape
    target = target[0]
    tile = min(tile, h, w)
    win_h = min(tile + 2 * _HALO, h)
    win_w = min(tile + 2 * _HALO, w)

    stats = None
    if mode == "adain":
        sums = [_moments(target, denorm, (1, 2)), _moments(source, False, (0, 1))]
        acc = np.asarray([[s.cpu().double().numpy() for s in pair]
                          for pair in sums])              # [2, 2, C]
        n = h * w
        means = acc[:, 0] / n
        stds = np.sqrt((acc[:, 1] - n * means ** 2) / max(n - 1, 1) + 1e-5)
        stats = tuple(torch.as_tensor(a, dtype=torch.float32,
                                      device=target.device)[:, None, None]
                      for a in (means[0], stds[0], means[1], stds[1]))
    elif mode == "nofix":
        zero = torch.zeros((c, 1, 1), device=target.device)
        stats = (zero, zero + 1, zero, zero + 1)

    out = np.empty((h, w, c), np.uint8 if to_uint8 else np.float32)
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            th, tw = min(tile, h - y0), min(tile, w - x0)
            wy = min(max(y0 - _HALO, 0), h - win_h)
            wx = min(max(x0 - _HALO, 0), w - win_w)
            # clamp the crop start so a full tile fits the window; the
            # residual offset is trimmed on the host
            oy = min(y0 - wy, win_h - tile)
            ox = min(x0 - wx, win_w - tile)
            dy, dx = (y0 - wy) - oy, (x0 - wx) - ox
            res = _window_fix(target, source, mode, to_uint8, denorm,
                              (wy, wx, win_h, win_w), (oy, ox, tile, tile),
                              stats)
            res = res.permute(1, 2, 0).cpu().numpy()
            out[y0:y0 + th, x0:x0 + tw] = res[dy:dy + th, dx:dx + tw]
    return out
