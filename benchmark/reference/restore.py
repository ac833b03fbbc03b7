"""Plain PyTorch reference of one FaithDiff restore (the reference CLI's
defaults: Euler, `start_point="lr"`, Gaussian-blended latent tiles,
classifier-free guidance, wavelet colour fix).

Everything runs in fp32 on the given models (`reference.models`); the
UNet runs one tile's CFG pair at a time. The schedule, the tile grid, the
blend weights and the colour fix are written again here from the
published definitions (diffusers' `EulerDiscreteScheduler` with
"leading" spacing, `DDPMScheduler.add_noise`, the FaithDiff tile grid,
the StableSR wavelet fix); nothing is taken from the program.

The noise follows the program's documented draws: one CPU
`torch.Generator` seeded with the request's seed gives the [1, 4, h, w]
initial noise and then the VAE posterior's N(0, 1).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# schedule (SDXL's scheduler config)
# --------------------------------------------------------------------------

def alphas_cumprod(s: dict) -> np.ndarray:
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5,
                        s["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def euler_schedule(s: dict, steps: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """(timesteps [S], sigmas [S+1] float32, init_noise_sigma) for
    "leading" spacing with `steps_offset`."""
    ac = alphas_cumprod(s)
    ratio = s["num_train_timesteps"] // steps
    ts = (np.arange(0, steps) * ratio).round()[::-1] + s["steps_offset"]
    train_sigmas = np.sqrt((1 - ac) / ac)
    sigmas = np.interp(ts.astype(np.float64), np.arange(len(train_sigmas)),
                       train_sigmas)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    init = float(np.float32((float(sigmas.max()) ** 2 + 1) ** 0.5))
    return ts.astype(np.float32), sigmas, init


# --------------------------------------------------------------------------
# tile grid and blend
# --------------------------------------------------------------------------

def tile_offsets(h: int, w: int, k: Tuple[int, int], overlap: float) -> List[Tuple[int, int]]:
    """Top-left corners of the FaithDiff tile grid: stride ceil(k *
    overlap), the last row and column flush with the edge."""
    k1, k2 = min(k[0], h), min(k[1], w)
    rows, cols = (h - 1) // k1 + 1, (w - 1) // k2 + 1
    si = k1 if rows == 1 else math.ceil(k1 * overlap)
    sj = k2 if cols == 1 else math.ceil(k2 * overlap)
    out, i, last_i = [], 0, False
    while i < h and not last_i:
        if i + k1 >= h:
            i, last_i = h - k1, True
        j, last_j = 0, False
        while j < w and not last_j:
            if j + k2 >= w:
                j, last_j = w - k2, True
            out.append((i, j))
            j += sj
        i += si
    return out


def gaussian_weights(th: int, tw: int, var: float = 0.01) -> torch.Tensor:
    """The blend mask, with the published midpoints (w - 1) / 2 and h / 2."""
    x = np.arange(tw, dtype=np.float64)
    y = np.arange(th, dtype=np.float64)
    px = np.exp(-(x - (tw - 1) / 2) ** 2 / (tw * tw) / (2 * var)) / math.sqrt(2 * math.pi * var)
    py = np.exp(-(y - th / 2) ** 2 / (th * th) / (2 * var)) / math.sqrt(2 * math.pi * var)
    return torch.from_numpy(np.outer(py, px).astype(np.float32))


# --------------------------------------------------------------------------
# colour fix
# --------------------------------------------------------------------------

def _blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    k = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32,
                     device=x.device) / 16
    c = x.shape[1]
    return F.conv2d(F.pad(x, (radius,) * 4, mode="replicate"),
                    k.expand(c, 1, 3, 3), dilation=radius, groups=c)


def _wavelet(x: torch.Tensor, levels: int = 5):
    high = torch.zeros_like(x)
    for i in range(levels):
        low = _blur(x, 2 ** i)
        high = high + (x - low)
        x = low
    return high, x


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_wavelet(target)[0] + _wavelet(source)[1], 0.0, 1.0)


# --------------------------------------------------------------------------
# weight precision of a configuration
# --------------------------------------------------------------------------

_FP8_SKIP = ("norm", "ln_")


def fp8_weight(name: str, t: torch.Tensor) -> bool:
    """The UNet tensors an fp8 deployment stores in float8_e4m3fn: every
    convolution and linear weight (2 or more dims) outside the norms;
    biases and norm parameters keep the compute dtype."""
    return t.ndim >= 2 and not any(s in name.lower() for s in _FP8_SKIP)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Round through the compute dtype (bf16) to float8_e4m3fn, NaN past
    464 (ml_dtypes' overflow), and back to fp32."""
    x = t.to(torch.bfloat16)
    x = torch.where(x.abs() <= 464.0, x, torch.nan)
    return x.to(torch.float8_e4m3fn).float()


def round_int4(t: torch.Tensor) -> torch.Tensor:
    """Symmetric int4 per output channel (levels -7 ... 7 of absmax / 7),
    back to fp32: one precision step below fp8 storage."""
    flat = t.reshape(t.shape[0], -1)
    scale = flat.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 7.0
    return (torch.round(flat / scale).clamp(-7, 7) * scale).reshape(t.shape)


@torch.no_grad()
def apply_weight_precision(unet: torch.nn.Module, mode: str) -> int:
    """Round the UNet's stored weights in place as `mode` ("bf16": none,
    "fp8", "int4") stores them. Returns the number of tensors rounded."""
    if mode == "bf16":
        return 0
    fn = {"fp8": round_fp8, "int4": round_int4}[mode]
    n = 0
    for name, p in unet.named_parameters():
        if fp8_weight(name, p):
            p.copy_(fn(p))
            n += 1
    return n


# --------------------------------------------------------------------------
# the restore
# --------------------------------------------------------------------------

def _image01(u8: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] uint8 -> [1, 3, H, W] fp32 in [0, 1]."""
    return (u8.float() / 255.0).permute(2, 0, 1)[None]


@torch.no_grad()
def denoise(models: Dict[str, torch.nn.Module], config: dict, image_u8: torch.Tensor,
            prompt: torch.Tensor, pooled: torch.Tensor, neg_prompt: torch.Tensor,
            neg_pooled: torch.Tensor, seed: int) -> torch.Tensor:
    """The restore up to the final latents: [1, h, w, 4] NHWC fp32."""
    p, sched = config["pipeline"], config["scheduler"]
    unet, vae, de = models["unet"], models["vae"], models["denoise_encoder"]
    dev = unet.conv_in.weight.device
    h, w = image_u8.shape[:2]
    lh, lw = h // 8, w // 8
    k = (min(p["tile_size"] // 8, lh), min(p["tile_size"] // 8, lw))
    offsets = tile_offsets(lh, lw, k, p["tile_overlap"])
    k1, k2 = min(k[0], lh), min(k[1], lw)

    image = _image01(image_u8.to(dev)) * 2.0 - 1.0
    lq = de(image)

    ts, sigmas, init_sigma = euler_schedule(sched, p["num_inference_steps"])
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn((1, 4, lh, lw), generator=gen).to(dev) * init_sigma
    mean, logvar = vae.encode_moments(image).chunk(2, dim=1)
    eps0 = torch.randn(mean.shape, generator=gen, dtype=torch.float32).to(dev)
    lr_latents = (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps0) \
        * config["vae"]["scaling_factor"]
    a = float(alphas_cumprod(sched).astype(np.float32)[999])
    latents = math.sqrt(a) * lr_latents + math.sqrt(1.0 - a) * noise

    ctx = torch.cat([neg_prompt, prompt]).to(dev).float()
    text = torch.cat([neg_pooled, pooled]).to(dev).float()
    weights = gaussian_weights(k1, k2).to(dev)
    g = p["guidance_scale"]
    for i in range(len(ts)):
        scale_in = 1.0 / math.sqrt(float(sigmas[i]) ** 2 + 1)
        dt = float(sigmas[i + 1]) - float(sigmas[i])
        acc = torch.zeros_like(latents[0])
        cnt = torch.zeros_like(latents[0, :1])
        for (oi, oj) in offsets:
            tile = latents[:, :, oi:oi + k1, oj:oj + k2]
            ids = torch.tensor([[h, w, oi, oj, h, w]] * 2, dtype=torch.float32,
                               device=dev)
            eps = unet(tile.repeat(2, 1, 1, 1) * scale_in, float(ts[i]), ctx, text,
                       ids, lq[:, :, oi:oi + k1, oj:oj + k2].repeat(2, 1, 1, 1),
                       add_sample=p["add_sample"], group=2)
            eps = eps[0] + g * (eps[1] - eps[0])
            acc[:, oi:oi + k1, oj:oj + k2] += (tile[0] + eps * dt) * weights
            cnt[:, oi:oi + k1, oj:oj + k2] += weights
        latents = (acc / cnt)[None]
    return latents.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def decode(models: Dict[str, torch.nn.Module], config: dict, latents_nhwc: torch.Tensor,
           image_u8: torch.Tensor) -> torch.Tensor:
    """Final latents and the input -> the [H, W, 3] uint8 output."""
    vae = models["vae"]
    dev = vae.post_quant_conv.weight.device
    z = latents_nhwc.to(dev).float().permute(0, 3, 1, 2) / config["vae"]["scaling_factor"]
    out = torch.clamp(vae.decode(z) / 2.0 + 0.5, 0.0, 1.0)
    out = wavelet_color_fix(out, _image01(image_u8.to(dev)))
    return torch.round(out * 255.0).to(torch.uint8)[0].permute(1, 2, 0)
