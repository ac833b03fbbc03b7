"""Host image runtime: decode + bilinear resize, its threaded batch form,
and the host-side Gaussian tile merge.

Counterpart of `faithdiff_tpu/native.py` (over `native/faithdiff_io.cc`,
which links libjpeg and libpng), here over the port's own host library
`csrc/host_io.cc` (no libjpeg, libpng or zlib), built by the host C++
compiler at first use. The arithmetic is that of the JAX module's native
route:

- `decode_resize` decodes a JPEG (`utils/jpeg`'s decoder, in the library)
  or a PNG (`utils/png.read_png`) to RGB, then resizes it bilinearly with
  pixel centres aligned, edges clamped, no antialiasing, in fp32 with the
  division by 255 last: float32 RGB in [0, 1].
- `decode_batch` does the same for many files on a pool of C++ threads
  (PNGs are decoded in Python first; their resize runs in the pool).
- `tile_merge_host` blends tiles under the reference's Gaussian mask.

There is no fallback: a file that does not decode, or a library that does
not build, raises. (The JAX module falls back to PIL's BILINEAR resize,
which antialiases when downscaling and so gives other values than its
native route; ROADMAP §3 records that. The port follows the native
route.) A PNG is read as Pillow's `convert("RGB")` reads it, where the
JAX native route uses libpng's transforms: the two differ only for 16-bit
gray PNGs (Pillow clips them to 255, libpng keeps the high byte).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from .ops import _build
from .utils.jpeg import JPEG_MAGIC
from .utils.png import read_png

_ERR_LEN = 1024


def _lib() -> ctypes.CDLL:
    lib = _build.load("host_io")
    if not getattr(lib, "_fd_native_typed", False):
        lib.fd_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int]
        lib.fd_decode_resize_batch.restype = ctypes.c_int
        lib.fd_tile_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.fd_tile_merge.restype = None
        lib._fd_native_typed = True
    return lib


def _is_jpeg(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(JPEG_MAGIC)) == JPEG_MAGIC


def decode_batch(paths: Sequence[str], width: int, height: int,
                 num_threads: int = 8) -> np.ndarray:
    """Decode + resize each file to (height, width) on `num_threads` C++
    threads -> [N, H, W, 3] float32 in [0, 1]. Raises ValueError naming
    the first file that failed."""
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    if n == 0:
        return out
    if width < 1 or height < 1:
        raise ValueError(f"decode_batch: output size {width}x{height}")
    pixels = [None if _is_jpeg(p) else np.ascontiguousarray(read_png(p))
              for p in paths]
    sizes = (ctypes.c_int * (2 * n))(*[x for px in pixels for x in (
        (0, 0) if px is None else (px.shape[1], px.shape[0]))])
    ptrs = (ctypes.c_void_p * n)(*[None if px is None else px.ctypes.data
                                   for px in pixels])
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err = ctypes.create_string_buffer(_ERR_LEN)
    failures = _lib().fd_decode_resize_batch(
        names, ptrs, sizes, n, out.ctypes.data, width, height,
        max(int(num_threads), 1), err, _ERR_LEN)
    if failures:
        raise ValueError(f"decode_batch: {failures} of {n} files failed; "
                         f"{err.value.decode()}")
    return out


def decode_resize(path: str, width: int, height: int) -> np.ndarray:
    """Decode a JPEG or PNG and resize it to (height, width): float32 RGB
    in [0, 1]. Raises on a missing or undecodable file."""
    return decode_batch([path], width, height, num_threads=1)[0]


def tile_merge_host(tiles: np.ndarray, offsets: np.ndarray,
                    canvas_hw) -> np.ndarray:
    """Host-side Gaussian blend-merge: tiles [T, k1, k2, C] at offsets
    [T, 2] (row, column) -> [H, W, C] float32, each pixel the mask-weighted
    mean of the tiles over it (`pipelines/tiling.merge_tiles`' arithmetic
    on the host)."""
    H, W = canvas_hw
    t, k1, k2, c = tiles.shape
    offs = np.ascontiguousarray(offsets, np.int32).reshape(t, 2)
    if t and ((offs < 0).any() or (offs[:, 0] + k1 > H).any()
              or (offs[:, 1] + k2 > W).any()):
        raise ValueError(f"tile_merge_host: tiles of {k1}x{k2} at {offs.tolist()} "
                         f"leave the {H}x{W} canvas")
    tiles_f = np.ascontiguousarray(tiles, np.float32)
    canvas = np.empty((H, W, c), np.float32)
    weight = np.empty((H, W), np.float32)
    _lib().fd_tile_merge(tiles_f.ctypes.data, offs.ctypes.data, t, k1, k2, c,
                         canvas.ctypes.data, weight.ctypes.data, H, W)
    return canvas
