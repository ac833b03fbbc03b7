"""Real-ESRGAN two-stage degradation engine (counterpart of
`faithdiff_tpu/data/degradation.py`): synthesises the LR side of
FaithDiff's training pairs from HR images on the card.

- blur-kernel synthesis is host numpy / scipy per sample, the basicsr
  families (iso / aniso Gaussian, generalized Gaussian, plateau, circular
  sinc), copied so that one `np.random.default_rng(seed)` gives the JAX
  package's kernels and plan;
- the apply path (per-sample `filter2d`, `resize`, noise, DiffJPEG,
  colour ops) is batched torch on [B, H, W, C] tensors in [0, 1];
- `resize` is `jax.image.resize`'s: the scale-and-translate weights of
  its triangle (linear, antialiased for "area") and Keys a = -0.5 cubic
  kernels, renormalised at the borders, one weight matrix a side and two
  products, not `F.interpolate`'s (a = -0.75, clamped borders, area as a
  box mean);
- the noise ops take their draws (sigma or scale, the gray flags, the
  normal or Poisson samples, the JPEG qualities) as tensors; a `Draws`
  object makes them, from a `torch.Generator` (`TorchDraws`) or, in a
  test, from the JAX package's key splits.

Output pair (GT, LQ) in [0, 1], LQ at 1/scale (4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import special as _sp_special  # Bessel j1 of the sinc kernels

from .jpeg import jpeg_compress, pad_to_16


# ---------------------------------------------------------------------------
# kernel synthesis (host numpy; basicsr.degradations equivalents)
# ---------------------------------------------------------------------------

def _mesh(kernel_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ax = np.arange(kernel_size) - kernel_size // 2
    xx, yy = np.meshgrid(ax, ax)
    return xx, yy, np.stack([xx, yy], -1)[..., None]


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0,
                       grid=None, isotropic=True) -> np.ndarray:
    xx, yy, xy = _mesh(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    kernel = np.exp(-0.5 * np.squeeze(xy.transpose(0, 1, 3, 2) @ inv @ xy))
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta,
                                   isotropic=True) -> np.ndarray:
    xx, yy, xy = _mesh(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    quad = np.squeeze(xy.transpose(0, 1, 3, 2) @ inv @ xy)
    kernel = np.exp(-0.5 * np.power(quad, beta))
    return kernel / kernel.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta,
                      isotropic=True) -> np.ndarray:
    xx, yy, xy = _mesh(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0], [0, sig_x ** 2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    quad = np.squeeze(xy.transpose(0, 1, 3, 2) @ inv @ xy)
    kernel = 1.0 / (np.power(quad, beta) + 1)
    return kernel / kernel.sum()


def circular_lowpass_kernel(omega_c: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2D sinc filter (basicsr `circular_lowpass_kernel` behavior)."""
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size {kernel_size} must be odd")
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx ** 2 + yy ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = omega_c * _sp_special.j1(omega_c * r) / (2 * np.pi * r)
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = \
        omega_c ** 2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel.astype(np.float32)


_KERNEL_RANGE = [2 * v + 1 for v in range(3, 11)]  # 7..21


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Mirrors the reference's `train_kernel.yml:24-42`."""

    kernel_list: Tuple[str, ...] = (
        "iso", "aniso", "generalized_iso", "generalized_aniso",
        "plateau_iso", "plateau_aniso")
    kernel_prob: Tuple[float, ...] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03)
    sinc_prob: float = 0.1
    blur_sigma: Tuple[float, float] = (0.2, 3.0)
    betag_range: Tuple[float, float] = (0.5, 4.0)
    betap_range: Tuple[float, float] = (1.0, 2.0)


def random_mixed_kernel(rng: np.random.Generator, cfg: KernelConfig,
                        kernel_size: int) -> np.ndarray:
    """basicsr `random_mixed_kernels` for one sample."""
    ktype = rng.choice(list(cfg.kernel_list), p=np.asarray(cfg.kernel_prob))
    sig_x = rng.uniform(*cfg.blur_sigma)
    sig_y = rng.uniform(*cfg.blur_sigma)
    theta = rng.uniform(-math.pi, math.pi)
    if ktype == "iso":
        return bivariate_gaussian(kernel_size, sig_x, isotropic=True)
    if ktype == "aniso":
        return bivariate_gaussian(kernel_size, sig_x, sig_y, theta,
                                  isotropic=False)
    if ktype == "generalized_iso":
        beta = rng.uniform(*cfg.betag_range)
        return bivariate_generalized_gaussian(
            kernel_size, sig_x, sig_y, theta, beta, isotropic=True)
    if ktype == "generalized_aniso":
        beta = rng.uniform(*cfg.betag_range)
        return bivariate_generalized_gaussian(
            kernel_size, sig_x, sig_y, theta, beta, isotropic=False)
    if ktype == "plateau_iso":
        beta = rng.uniform(*cfg.betap_range)
        return bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta,
                                 isotropic=True)
    beta = rng.uniform(*cfg.betap_range)
    return bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta,
                             isotropic=False)


def sample_degradation_kernel(rng: np.random.Generator,
                              cfg: KernelConfig) -> np.ndarray:
    """One stage-1/2 blur kernel, padded to 21x21
    (`realesrgan.py:129-174`)."""
    kernel_size = int(rng.choice(_KERNEL_RANGE))
    if rng.uniform() < cfg.sinc_prob:
        # sinc cutoff range depends on kernel size (`realesrgan.py:134-137`)
        if kernel_size < 13:
            omega_c = rng.uniform(np.pi / 3, np.pi)
        else:
            omega_c = rng.uniform(np.pi / 5, np.pi)
        kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
    else:
        kernel = random_mixed_kernel(rng, cfg, kernel_size)
    pad = (21 - kernel_size) // 2
    return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)


def sample_final_sinc_kernel(rng: np.random.Generator,
                             final_sinc_prob: float = 0.8) -> np.ndarray:
    """Final sinc kernel or identity pulse (`realesrgan.py:176-183`)."""
    if rng.uniform() < final_sinc_prob:
        kernel_size = int(rng.choice(_KERNEL_RANGE))
        omega_c = rng.uniform(np.pi / 3, np.pi)
        return circular_lowpass_kernel(omega_c, kernel_size, pad_to=21)
    pulse = np.zeros((21, 21), np.float32)
    pulse[10, 10] = 1.0
    return pulse


# ---------------------------------------------------------------------------
# apply ops (torch, any device)
# ---------------------------------------------------------------------------

def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" padding of a length-n axis by `pad`
    each side (edge not repeated; periodic past one reflection)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - m, m)


def filter2d(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-sample 2D filtering (cross-correlation) with reflect padding,
    basicsr's `filter2D`: image [B, H, W, C], kernel [B, k, k], one grouped
    convolution with a group per (sample, channel)."""
    b, h, w, c = image.shape
    k = kernel.shape[-1]
    pad = k // 2
    x = image.permute(0, 3, 1, 2)
    x = x.index_select(2, _reflect_index(h, pad, x.device))
    x = x.index_select(3, _reflect_index(w, pad, x.device))
    x = x.reshape(1, b * c, h + 2 * pad, w + 2 * pad)
    weight = kernel.to(image.dtype)[:, None].expand(b, c, k, k).reshape(
        b * c, 1, k, k)
    out = F.conv2d(x, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5 on |x| (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def resize_weights(in_size: int, out_size: int, kernel, antialias: bool,
                   device=None) -> torch.Tensor:
    """[in, out] fp32 weights of `jax.image.scale_and_translate` along one
    axis (`compute_weight_mat`, translation 0): a scaled kernel when
    antialiasing a downsample, each output column normalised to sum 1
    (zero when its sum is below 1000 eps), zero where the sample falls
    outside the input."""
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32, device=device)
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.tensor(1.0, device=device))
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


_RESIZE = {"area": (_triangle, True), "bilinear": (_triangle, False),
           "bicubic": (_keys_cubic, False)}


def resize(image: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """Resize [B, H, W, C] to `size` (H, W) as `jax.image.resize` does:
    "area" is linear with antialiasing, "bilinear" linear, "bicubic"
    Keys cubic; an axis whose size does not change is left as it is. The
    rows are resampled first, then the columns."""
    if method not in _RESIZE:
        raise ValueError(method)
    kernel, antialias = _RESIZE[method]
    h, w = image.shape[1:3]
    out = image
    if size[0] != h:
        wh = resize_weights(h, size[0], kernel, antialias, image.device)
        out = torch.einsum("bhwc,hk->bkwc", out, wh.to(image.dtype))
    if size[1] != w:
        ww = resize_weights(w, size[1], kernel, antialias, image.device)
        out = torch.einsum("bhwc,wk->bhkc", out, ww.to(image.dtype))
    return out


def _per_sample(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.to(like.device, like.dtype).reshape(-1, 1, 1, 1)


def add_gaussian_noise(image: torch.Tensor, sigma: torch.Tensor,
                       gray: torch.Tensor, noise: torch.Tensor,
                       clip: bool = True) -> torch.Tensor:
    """basicsr's `random_add_gaussian_noise_pt` with its draws given:
    `sigma` [B] (already / 255), `gray` [B] bool (the first channel's
    noise shared by all), `noise` [B, H, W, C] N(0, 1)."""
    noise = noise.to(image.device, image.dtype)
    noise = torch.where(gray.to(image.device).reshape(-1, 1, 1, 1),
                        noise[..., :1].expand_as(noise), noise)
    out = image + noise * _per_sample(sigma, image)
    return torch.clamp(out, 0.0, 1.0) if clip else out


POISSON_LEVELS = 256.0


def add_poisson_noise(image: torch.Tensor, scale: torch.Tensor,
                      gray: torch.Tensor, counts: torch.Tensor,
                      counts_gray: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """basicsr's `random_add_poisson_noise_pt` at 256 levels with its draws
    given: `scale` [B], `gray` [B] bool, `counts` Poisson samples of rate
    clip(image) * 256 [B, H, W, C] and `counts_gray` of the channel mean
    [B, H, W, 1]."""
    dev = image.device
    img_c = torch.clamp(image, 0.0, 1.0)
    gray_c = torch.clamp(image.mean(dim=-1, keepdim=True), 0.0, 1.0)
    noise_color = counts.to(dev, image.dtype) / POISSON_LEVELS - img_c
    noise_gray = (counts_gray.to(dev, image.dtype) / POISSON_LEVELS
                  - gray_c).expand_as(image)
    noise = torch.where(gray.to(dev).reshape(-1, 1, 1, 1), noise_gray,
                        noise_color)
    out = image + noise * _per_sample(scale, image)
    return torch.clamp(out, 0.0, 1.0) if clip else out


class TorchDraws:
    """The noise ops' draws from a `torch.Generator` (on its own device).
    `stage` (0 or 1) names the degradation stage; it selects the JAX
    package's key in a test's draws and is not used here."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def _uniform(self, n, lo, hi):
        u = torch.rand(n, generator=self.g, device=self.g.device)
        return lo + u * (hi - lo)

    def gaussian(self, stage: int, shape, sigma_range, gray_prob):
        b = shape[0]
        sigma = self._uniform(b, *sigma_range) / 255.0
        gray = self._uniform(b, 0.0, 1.0) < gray_prob
        noise = torch.randn(tuple(shape), generator=self.g, device=self.g.device)
        return sigma, gray, noise

    def poisson(self, stage: int, image: torch.Tensor, scale_range, gray_prob):
        b = image.shape[0]
        scale = self._uniform(b, *scale_range)
        gray = self._uniform(b, 0.0, 1.0) < gray_prob
        rate = torch.clamp(image.float(), 0.0, 1.0).to(self.g.device) * POISSON_LEVELS
        gray_rate = torch.clamp(image.float().mean(dim=-1, keepdim=True), 0.0,
                                1.0).to(self.g.device) * POISSON_LEVELS
        return (scale, gray, torch.poisson(rate, generator=self.g),
                torch.poisson(gray_rate, generator=self.g))

    def jpeg_quality(self, stage: int, b: int, lo: float, hi: float):
        return self._uniform(b, lo, hi)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], device=image.device,
                     dtype=image.dtype)
    return (image @ w)[..., None].expand_as(image)


# color jitter (torchvision-functional semantics, as basicsr's
# `color_jitter_pt` in the reference's second stage)

def adjust_brightness(image: torch.Tensor, factor: float) -> torch.Tensor:
    return torch.clamp(image * factor, 0.0, 1.0)


def adjust_contrast(image: torch.Tensor, factor: float) -> torch.Tensor:
    mean = rgb_to_grayscale(image)[..., :1].mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp(factor * image + (1.0 - factor) * mean, 0.0, 1.0)


def adjust_saturation(image: torch.Tensor, factor: float) -> torch.Tensor:
    gray = rgb_to_grayscale(image)
    return torch.clamp(factor * image + (1.0 - factor) * gray, 0.0, 1.0)


def _rgb_to_hsv(image: torch.Tensor):
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    maxc = image.max(dim=-1).values
    minc = image.min(dim=-1).values
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def adjust_hue(image: torch.Tensor, factor: float) -> torch.Tensor:
    """Shift hue by `factor` (in turns, [-0.5, 0.5])."""
    h, s, v = _rgb_to_hsv(torch.clamp(image, 0.0, 1.0))
    return _hsv_to_rgb(torch.remainder(h + factor, 1.0), s, v)


def color_jitter(image: torch.Tensor, rng: np.random.Generator,
                 brightness=(0.5, 1.5), contrast=(0.5, 1.5),
                 saturation=(0.0, 1.5), hue=(-0.1, 0.1)) -> torch.Tensor:
    """Brightness / contrast / saturation / hue in a random order, factors
    drawn on the host as the JAX package draws them."""
    ops = {
        0: lambda im: adjust_brightness(im, rng.uniform(*brightness)),
        1: lambda im: adjust_contrast(im, rng.uniform(*contrast)),
        2: lambda im: adjust_saturation(im, rng.uniform(*saturation)),
        3: lambda im: adjust_hue(im, rng.uniform(*hue)),
    }
    for fn_id in rng.permutation(4):
        image = ops[int(fn_id)](image)
    return image


# ---------------------------------------------------------------------------
# the two-stage pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Mirrors the reference's `dataloader/train_kernel.yml`."""

    scale: int = 4
    resize_prob: Tuple[float, float, float] = (0.2, 0.7, 0.1)
    resize_range: Tuple[float, float] = (0.3, 1.5)
    gaussian_noise_prob: float = 0.5
    noise_range: Tuple[float, float] = (1, 15)
    poisson_scale_range: Tuple[float, float] = (0.05, 2.0)
    gray_noise_prob: float = 0.4
    jpeg_range: Tuple[float, float] = (60, 95)
    second_blur_prob: float = 0.5
    resize_prob2: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    resize_range2: Tuple[float, float] = (0.6, 1.2)
    gaussian_noise_prob2: float = 0.5
    noise_range2: Tuple[float, float] = (1, 12)
    poisson_scale_range2: Tuple[float, float] = (0.05, 1.0)
    gray_noise_prob2: float = 0.4
    jpeg_range2: Tuple[float, float] = (60, 100)
    gray_prob: float = 0.0
    color_jitter_prob: float = 0.0
    kernel1: KernelConfig = KernelConfig()
    kernel2: KernelConfig = KernelConfig(blur_sigma=(0.2, 1.5))
    final_sinc_prob: float = 0.8


_MODES = ("area", "bilinear", "bicubic")


class RealESRGANDegradation:
    """Two-stage degradation: a host plan from `np.random.default_rng(seed)`
    (the JAX package's, call for call) and batched torch ops on the
    images' device. Stage 1: blur, random resize, Gaussian or Poisson
    noise, JPEG. Stage 2: an optional blur, resize, noise, then JPEG and
    the resize to 1/scale with the final sinc, in a random order."""

    def __init__(self, config: DegradationConfig = DegradationConfig(),
                 seed: int = 0):
        self.cfg = config
        self.rng = np.random.default_rng(seed)

    def _choice(self, probs) -> int:
        return int(self.rng.choice(len(probs), p=np.asarray(probs) / np.sum(probs)))

    def _scale(self, probs, scale_range) -> float:
        updown = self._choice(probs)
        if updown == 0:
            return self.rng.uniform(1, scale_range[1])
        if updown == 1:
            return self.rng.uniform(scale_range[0], 1)
        return 1.0

    def _mode(self) -> str:
        return _MODES[int(self.rng.integers(3))]

    def _noise(self, draws, stage: int, out: torch.Tensor, gaussian_prob,
               noise_range, poisson_range, gray_prob) -> torch.Tensor:
        if self.rng.uniform() < gaussian_prob:
            sigma, gray, noise = draws.gaussian(stage, out.shape, noise_range,
                                                gray_prob)
            return add_gaussian_noise(out, sigma, gray, noise)
        scale, gray, counts, counts_gray = draws.poisson(stage, out,
                                                         poisson_range, gray_prob)
        return add_poisson_noise(out, scale, gray, counts, counts_gray)

    @staticmethod
    def _jpeg(out: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
        padded, h0, w0 = pad_to_16(torch.clamp(out, 0, 1))
        return jpeg_compress(padded, quality)[:, :h0, :w0]

    def __call__(self, gt: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """gt: [B, H, W, 3] fp32 in [0, 1]. The draws come from `draws`, or
        from `generator` (`TorchDraws`). Returns (gt, lq), lq at 1/scale,
        rounded to 8-bit levels."""
        if draws is None:
            if generator is None:
                raise ValueError("RealESRGANDegradation: give a generator "
                                 "or draws")
            draws = TorchDraws(generator)
        cfg, rng = self.cfg, self.rng
        b, ori_h, ori_w, _ = gt.shape
        dev = gt.device

        def kernels(fn):
            return torch.from_numpy(np.stack([fn() for _ in range(b)])).to(dev)

        kernel1 = kernels(lambda: sample_degradation_kernel(rng, cfg.kernel1))
        kernel2 = kernels(lambda: sample_degradation_kernel(rng, cfg.kernel2))
        sinc = kernels(lambda: sample_final_sinc_kernel(rng, cfg.final_sinc_prob))

        # stage 1
        out = filter2d(gt, kernel1)
        scale = self._scale(cfg.resize_prob, cfg.resize_range)
        out = resize(out, (max(int(ori_h * scale), 8), max(int(ori_w * scale), 8)),
                     self._mode())
        out = self._noise(draws, 0, out, cfg.gaussian_noise_prob,
                          cfg.noise_range, cfg.poisson_scale_range,
                          cfg.gray_noise_prob)
        out = self._jpeg(out, draws.jpeg_quality(0, b, *cfg.jpeg_range))

        # stage 2
        if rng.uniform() < cfg.second_blur_prob:
            out = filter2d(out, kernel2)
        scale = self._scale(cfg.resize_prob2, cfg.resize_range2)
        out = resize(out, (max(int(ori_h / cfg.scale * scale), 8),
                           max(int(ori_w / cfg.scale * scale), 8)), self._mode())
        out = self._noise(draws, 1, out, cfg.gaussian_noise_prob2,
                          cfg.noise_range2, cfg.poisson_scale_range2,
                          cfg.gray_noise_prob2)
        quality = draws.jpeg_quality(1, b, *cfg.jpeg_range2)
        final_size = (ori_h // cfg.scale, ori_w // cfg.scale)
        mode = self._mode()
        if rng.uniform() < 0.5:
            out = filter2d(resize(out, final_size, mode), sinc)
            out = self._jpeg(out, quality)
        else:
            out = self._jpeg(out, quality)
            out = filter2d(resize(out, final_size, mode), sinc)

        if rng.uniform() < cfg.gray_prob:
            out = rgb_to_grayscale(out)
        if rng.uniform() < cfg.color_jitter_prob:
            out = color_jitter(torch.clamp(out, 0.0, 1.0), rng)

        lq = torch.clamp(torch.round(torch.clamp(out, 0, 1) * 255.0), 0, 255) / 255.0
        return gt, lq
