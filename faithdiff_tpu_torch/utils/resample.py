"""Pillow's NEAREST, BILINEAR, BICUBIC and LANCZOS resampling of uint8
images, in numpy.

The port's copy of `libImaging/Resample.c` for 8-bit images, so that
`resize_bilinear`, `resize_bicubic` and `resize_lanczos` give what
`Image.resize(size, Image.BILINEAR / BICUBIC / LANCZOS)` gives, bit for
bit: a
separable convolution, the horizontal pass first and each pass rounding
to uint8. An output pixel's taps are the filter at its input pixels'
centres (widened by the scale when shrinking), normalised by their
sequential sum, then held in fixed point with 22 fractional bits and
rounded half away from zero. A pass whose axis keeps its size is skipped.
`resize_nearest` is Pillow's NEAREST, which goes through its affine
scaler (`ImagingScaleAffine` of `libImaging/Geometry.c`) instead: output
pixel x takes input pixel int(x0 + (x + 1/2) * in/out), the position
advanced by in/out a pixel in double precision.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

_PRECISION_BITS = 22


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """Truncated sinc, 3 lobes (Pillow's `lanczos_filter`)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


# filter -> support at scale 1
_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0),
            "lanczos": (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, fn: Callable[[float], float],
            support: float) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index [out], fixed-point taps [out, ksize]) of one axis;
    taps past an output pixel's window are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:                         # Pillow's sequential sum
            total += v
        for x, v in enumerate(w):
            if total != 0.0:
                v /= total
            scaled = v * (1 << _PRECISION_BITS)
            taps[xx, x] = int(scaled - 0.5) if v < 0 else int(scaled + 0.5)
        first[xx] = xmin
    return first, taps


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   kind: str) -> np.ndarray:
    in_size = img.shape[axis]
    first, taps = _coeffs(in_size, out_size, *_FILTERS[kind])
    src = np.moveaxis(img, axis, 0)
    # int32 as in Pillow: |taps| sum to under 2^23, so 255 x that fits
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(taps.shape[1]):
        idx = np.minimum(first + j, in_size - 1)
        k = taps[:, j].astype(np.int32).reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx] * k
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize(img: np.ndarray, size: Tuple[int, int], kind: str) -> np.ndarray:
    if img.dtype != np.uint8:
        raise TypeError(f"resize_{kind}: {img.dtype} image, takes uint8")
    out_w, out_h = size
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize_{kind}: size {size}")
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1, kind)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0, kind)
    return np.ascontiguousarray(img)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 HW or HWC image -> (width, height) `size`, as PIL's
    `Image.resize(size, Image.BICUBIC)` gives it."""
    return _resize(img, size, "bicubic")


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 HW or HWC image -> (width, height) `size`, as PIL's
    `Image.resize(size, Image.LANCZOS)` gives it."""
    return _resize(img, size, "lanczos")


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 HW or HWC image -> (width, height) `size`, as PIL's
    `Image.resize(size, Image.BILINEAR)` gives it."""
    return _resize(img, size, "bilinear")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = step * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        idx[x] = int(pos)
        pos += step
    return idx


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 HW or HWC image -> (width, height) `size`, as PIL's
    `Image.resize(size, Image.NEAREST)` gives it."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_nearest: {img.dtype} image, takes uint8")
    out_w, out_h = size
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize_nearest: size {size}")
    rows = _nearest_index(img.shape[0], out_h)
    cols = _nearest_index(img.shape[1], out_w)
    return np.ascontiguousarray(img[rows][:, cols])
