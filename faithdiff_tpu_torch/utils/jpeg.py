"""JPEG input: the port's own decoder (`csrc/host_io.cc`, through ctypes).

`decode_jpeg(data)` / `read_jpeg(path)` give the [H, W, 3] uint8 RGB array
that `np.asarray(Image.open(p).convert("RGB"))` gives with Pillow's
libjpeg-turbo, byte for byte: baseline, extended sequential and
progressive Huffman JPEG, 8-bit, gray or three components, any of the
4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 samplings, restart intervals. What the
decoder does not take (arithmetic coding, lossless and hierarchical
files, 12-bit samples, CMYK / YCCK) and any truncated or malformed stream
raise ValueError naming the file; there is no other decoder behind it.

The host library is built by the host C++ compiler at first use
(`ops/_build.load("host_io")`); without one, the first call raises naming
the missing compiler. (`data/jpeg.py` is another thing: the training
data's differentiable JPEG simulator.)
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

# the first bytes of every JPEG file (SOI and the next marker's 0xFF)
JPEG_MAGIC = b"\xff\xd8\xff"
_ERR_LEN = 512


def _lib() -> ctypes.CDLL:
    lib = _build.load("host_io")
    if not getattr(lib, "_fd_jpeg_typed", False):
        size = ctypes.POINTER(ctypes.c_int)
        lib.fd_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, size,
                                     size, ctypes.c_char_p, ctypes.c_int]
        lib.fd_jpeg_info.restype = ctypes.c_int
        lib.fd_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.fd_jpeg_decode.restype = ctypes.c_int
        lib._fd_jpeg_typed = True
    return lib


def is_jpeg(data: bytes) -> bool:
    return data[:3] == JPEG_MAGIC


def jpeg_size(data: bytes, path: str = "<JPEG bytes>") -> tuple:
    """(width, height) from a JPEG's frame header. Raises ValueError, naming
    `path`, on a header the decoder does not take (a truncated file, an
    arithmetic-coded, lossless, hierarchical, 12-bit or CMYK one)."""
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if _lib().fd_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                           err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return w.value, h.value


def decode_jpeg(data: bytes, path: str = "<JPEG bytes>") -> np.ndarray:
    """[H, W, 3] uint8 RGB of a JPEG file's bytes; `path` names it in
    errors. Raises ValueError on what the decoder does not take."""
    w, h = jpeg_size(data, path)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().fd_jpeg_decode(data, len(data), out.ctypes.data, w, h, err,
                             _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """`decode_jpeg` of a file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
