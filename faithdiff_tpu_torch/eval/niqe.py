"""NIQE (Mittal et al. 2013, "Making a 'Completely Blind' Image Quality
Analyzer"; the port's copy of `faithdiff_tpu/eval/niqe.py`).

The reference scores NIQE through pyiqa (`test_metrics.py:127-141`).
The complete algorithm is here, on the host in numpy / scipy (float64
features, zero-padded filtering), as in the JAX package:
- MSCN transform with the 7x7 Gaussian (sigma = 7/6)
- AGGD moment-matching fits on MSCN and its 4 pairwise-product maps
  (18 features per scale, 2 scales, 96x96 patches)
- multivariate-Gaussian fit + the NIQE Mahalanobis-style distance

Pristine-model parameters (mu, cov over patch features) load from an .npz;
`fit_niqe_params` produces one from any directory of pristine images, so
the metric is fully self-contained once a corpus is on disk. Without a
params file the harness reports the metric as UNAVAILABLE instead of
silently dropping it.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
try:
    from scipy.special import gamma as _gamma_fn
except ImportError:  # pragma: no cover
    import math

    def _gamma_fn(x):
        return np.vectorize(math.gamma)(x)

_R_GAM = (_gamma_fn(2.0 / _GAMMA_RANGE) ** 2 /
          (_gamma_fn(1.0 / _GAMMA_RANGE) * _gamma_fn(3.0 / _GAMMA_RANGE)))


def _gaussian_kernel(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float64)


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'same' correlation with symmetric (reflect) padding, matching the
    MATLAB reference's imfilter(..., 'replicate' is NOT used; the original
    uses default zero-padding then crops borders via 'same')."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    padded = np.pad(img, ((ph, ph), (pw, pw)), mode="constant")
    # separable? kernel is outer(g, g): split for speed
    out = np.zeros_like(img, dtype=np.float64)
    # direct conv via FFT-free sliding window using stride tricks
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(padded, (kh, kw))
    out = np.einsum("ijkl,kl->ij", win, kernel)
    return out


def mscn(img: np.ndarray, c: float = 1.0) -> np.ndarray:
    """Mean-subtracted contrast-normalised coefficients of a gray image."""
    img = img.astype(np.float64)
    k = _gaussian_kernel()
    mu = _filter2(img, k)
    sigma = np.sqrt(np.abs(_filter2(img * img, k) - mu * mu))
    return (img - mu) / (sigma + c)


def fit_aggd(x: np.ndarray) -> Tuple[float, float, float]:
    """Asymmetric generalized Gaussian moment-matching fit.
    Returns (alpha, beta_left, beta_right)."""
    x = x.ravel()
    left = x[x < 0]
    right = x[x >= 0]
    sigma_l = np.sqrt(np.mean(left ** 2)) if left.size else 1e-6
    sigma_r = np.sqrt(np.mean(right ** 2)) if right.size else 1e-6
    gamma_hat = sigma_l / max(sigma_r, 1e-9)
    m1 = np.mean(np.abs(x))
    m2 = np.mean(x ** 2)
    r_hat = (m1 ** 2) / max(m2, 1e-12)
    rhat_norm = r_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / \
        (gamma_hat ** 2 + 1) ** 2
    idx = int(np.argmin((_R_GAM - rhat_norm) ** 2))
    alpha = float(_GAMMA_RANGE[idx])
    conv = np.sqrt(_gamma_fn(1.0 / alpha) / _gamma_fn(3.0 / alpha))
    return alpha, float(sigma_l * conv), float(sigma_r * conv)


def _subband_feats(m: np.ndarray) -> np.ndarray:
    """18 NIQE features of one MSCN map: AGGD on the map itself (2) + AGGD
    on 4 pairwise products (4 each)."""
    feats = []
    alpha, bl, br = fit_aggd(m)
    feats += [alpha, (bl + br) / 2.0]
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        shifted = np.roll(np.roll(m, dy, axis=0), dx, axis=1)
        pair = (m * shifted).ravel()
        alpha, bl, br = fit_aggd(pair)
        eta = (br - bl) * (_gamma_fn(2.0 / alpha) /
                           _gamma_fn(1.0 / alpha))
        feats += [alpha, float(eta), bl, br]
    return np.asarray(feats, np.float64)


def _to_gray(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] in [0, 1] or [0, 255] -> luminance in [0, 255]."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2])
    if img.max() <= 1.5:
        img = img * 255.0
    return img


def niqe_features(
    img: np.ndarray, patch_size: int = 96,
    sharpness_threshold: Optional[float] = None,
) -> np.ndarray:
    """[N_patches, 36] feature matrix over 2 scales.

    `sharpness_threshold` (0..1, fraction of the max patch variance) selects
    only sharp patches — used when FITTING the pristine model, not when
    scoring (the original's protocol)."""
    gray = _to_gray(img)
    h, w = gray.shape
    nh, nw = h // patch_size, w // patch_size
    if nh == 0 or nw == 0:
        raise ValueError(f"image {h}x{w} smaller than patch {patch_size}")
    gray = gray[: nh * patch_size, : nw * patch_size]

    # patch sharpness from the scale-1 local sigma field
    k = _gaussian_kernel()
    mu = _filter2(gray, k)
    sigma = np.sqrt(np.abs(_filter2(gray * gray, k) - mu * mu))

    maps = [mscn(gray)]
    # scale 2: 2x downsample (average 2x2) then MSCN
    small = gray.reshape(nh * patch_size // 2, 2,
                         nw * patch_size // 2, 2).mean(axis=(1, 3))
    maps.append(mscn(small))

    feats_all = []
    sharpness = []
    for i in range(nh):
        for j in range(nw):
            f = []
            for s, m in enumerate(maps):
                p = patch_size // (2 ** s)
                patch = m[i * p:(i + 1) * p, j * p:(j + 1) * p]
                f.append(_subband_feats(patch))
            feats_all.append(np.concatenate(f))
            sp = sigma[i * patch_size:(i + 1) * patch_size,
                       j * patch_size:(j + 1) * patch_size]
            sharpness.append(sp.mean())
    feats = np.stack(feats_all)
    if sharpness_threshold is not None:
        sharp = np.asarray(sharpness)
        keep = sharp > sharpness_threshold * sharp.max()
        if keep.any():
            feats = feats[keep]
    return feats


def fit_mvg(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.nanmean(feats, axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def fit_niqe_params(
    images: Sequence[np.ndarray], save_path: Optional[str] = None,
    patch_size: int = 96,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit the pristine-corpus MVG from images (HWC, [0,1] or uint8)."""
    feats = np.concatenate([
        niqe_features(im, patch_size, sharpness_threshold=0.75)
        for im in images])
    mu, cov = fit_mvg(feats)
    if save_path:
        np.savez(save_path, mu=mu, cov=cov, patch_size=patch_size)
    return mu, cov


def load_niqe_params(path: str):
    z = np.load(path)
    return z["mu"], z["cov"], int(z.get("patch_size", 96))


def niqe(
    img: np.ndarray,
    pristine_mu: np.ndarray,
    pristine_cov: np.ndarray,
    patch_size: int = 96,
) -> float:
    """NIQE score (lower = more natural)."""
    feats = niqe_features(img, patch_size)
    mu_d, cov_d = fit_mvg(feats)
    diff = pristine_mu - mu_d
    pooled = (pristine_cov + cov_d) / 2.0
    inv = np.linalg.pinv(pooled)
    return float(np.sqrt(max(diff @ inv @ diff, 0.0)))


DEFAULT_PARAMS_PATH = os.path.join(
    os.path.dirname(__file__), "niqe_pristine_params.npz")


def make_niqe_metric(params_path: Optional[str] = None):
    """Returns callable(img)->float, or None when no pristine params exist
    (the harness then reports NIQE as UNAVAILABLE)."""
    path = params_path or DEFAULT_PARAMS_PATH
    if not os.path.exists(path):
        return None
    mu, cov, patch = load_niqe_params(path)

    def call(img: np.ndarray, _mu=mu, _cov=cov, _p=patch) -> float:
        return niqe(img, _mu, _cov, _p)

    return call
