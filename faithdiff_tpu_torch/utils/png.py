"""PNG read and write on the standard library's `zlib` and numpy.

`read_png` decodes a PNG of color type 0 (gray, 1/2/4/8/16 bits), 2 (RGB,
8/16), 3 (palette, 1/2/4/8), 4 (gray + alpha, 8/16) or 6 (RGBA, 8/16),
interlaced (Adam7) or not, to the [H, W, 3] uint8 array that
`np.asarray(Image.open(p).convert("RGB"))` gives with Pillow 12: alpha
and transparency (`tRNS`) are dropped, gray is replicated, gray below 8
bits is scaled to 0..255, 16-bit RGB, RGBA and gray + alpha keep their
high byte, and 16-bit gray (Pillow's mode `I;16`) is clipped to 255, not
shifted. `decode_png` does the same from a file's bytes. `decode_image` /
`read_rgb` take a JPEG or a PNG, told apart by their first bytes (`FF D8
FF` is JPEG, decoded by `utils/jpeg`): the input of the CLI, the eval
harnesses and the servers. `encode_png` gives an [H, W, 3] uint8 array as
an 8-bit RGB PNG's bytes; `write_png` writes them to a file.

The five scanline filters are undone together along anti-diagonals: a
byte depends only on its left, upper and upper-left neighbours, so every
pixel with the same row + column is independent of the others, and a
whole diagonal is one vectorised step (H + W steps an image). An Adam7
image is seven such sub-images, each filtered on its own, scattered back
onto the pixel grid.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg, is_jpeg, jpeg_size

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (channels, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n] or b"\0" * 4)
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or corrupt")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (a filter-type byte each) -> [height, rowbytes]
    uint8, by anti-diagonals of bpp-byte cells."""
    rows = raw[:height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    ncols = rowbytes // bpp
    filt = rows[:, 1:].reshape(height, ncols, bpp).astype(np.int32)
    # out[r + 1, c + 1] is cell (r, c); row 0 and column 0 are the zeros
    # PNG takes for bytes before the image
    out = np.zeros((height + 1, ncols + 1, bpp), np.int32)
    for d in range(height + ncols - 1):
        r = np.arange(max(0, d - ncols + 1), min(height - 1, d) + 1)
        c = d - r
        x = filt[r, c]
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        f = ftype[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, ul), 0))))
        out[r + 1, c + 1] = (x + pred) & 0xFF
    return out[1:, 1:].reshape(height, rowbytes).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """[H, rowbytes] unfiltered scanlines -> [H, width, channels] samples
    (uint16 at 16 bits, big-endian; else uint8, packed ones MSB first)."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows.reshape(h, width * channels, 2).astype(np.uint16)
        return ((pairs[..., 0] << 8) | pairs[..., 1]).reshape(h, width, channels)
    if depth == 8:
        return rows.reshape(h, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _decode(raw: np.ndarray, width: int, height: int, depth: int,
            channels: int, interlace: int, path: str) -> np.ndarray:
    """Inflated image data -> [H, W, channels] samples, Adam7 passes
    scattered back onto the grid."""
    bpp = max(1, channels * depth // 8)
    passes = (_ADAM7 if interlace else ((0, 0, 1, 1),))
    out = None
    pos = 0
    for r0, c0, dr, dc in passes:
        h, w = -(-(height - r0) // dr), -(-(width - c0) // dc)
        if h <= 0 or w <= 0:
            continue                  # an empty pass has no scanlines
        rowbytes = (w * channels * depth + 7) // 8
        need = h * (rowbytes + 1)
        if raw.size < pos + need:
            raise ValueError(f"{path}: {raw.size} bytes of image data, "
                             f"{pos + need} or more expected")
        sub = _samples(_unfilter(raw[pos:pos + need], h, rowbytes, bpp),
                       w, depth, channels)
        pos += need
        if not interlace:
            return sub
        if out is None:
            out = np.zeros((height, width, channels), sub.dtype)
        out[r0::dr, c0::dc] = sub
    return out


def _to_rgb(samples: np.ndarray, ctype: int, depth: int, palette,
            path: str) -> np.ndarray:
    """Samples -> [H, W, 3] uint8 as Pillow's `convert("RGB")` gives them."""
    if ctype == 3:
        values = samples[..., 0]
        if values.max() >= len(palette):
            raise ValueError(f"{path}: palette index past the "
                             f"{len(palette)} PLTE entries")
        return palette[values]
    if ctype == 0 and depth == 16:
        gray = np.minimum(samples[..., 0], 255).astype(np.uint8)
    elif ctype == 0 and depth < 8:
        gray = (samples[..., 0].astype(np.int32) * 255
                // ((1 << depth) - 1)).astype(np.uint8)
    else:
        color = samples[..., :1] if ctype in (0, 4) else samples[..., :3]
        if depth == 16:
            color = color >> 8
        color = color.astype(np.uint8)
        if ctype == 2 or ctype == 6:
            return np.ascontiguousarray(color)
        gray = color[..., 0]
    return np.repeat(gray[..., None], 3, axis=2)


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a PNG file, as Pillow's `convert("RGB")`
    gives it. Raises ValueError on a malformed or unsupported file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_image(data: bytes, path: str = "<image bytes>") -> np.ndarray:
    """[H, W, 3] uint8 RGB of a JPEG's or a PNG's bytes, as Pillow's
    `convert("RGB")` gives it; the first bytes say which. Raises ValueError
    on a malformed or unsupported file."""
    if is_jpeg(data):
        return decode_jpeg(data, path)
    return decode_png(data, path)


def read_rgb(path: str) -> np.ndarray:
    """`decode_image` of a file, whatever its name says."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def check_image(path: str) -> None:
    """Raise ValueError, naming `path`, unless the file is a PNG or a JPEG
    whose header the decoder takes: the CLI's and the harness's check of
    every input before a weight is read (a stream damaged past its header
    raises when it is decoded)."""
    with open(path, "rb") as f:
        data = f.read()
    if is_jpeg(data):
        jpeg_size(data, path)
    elif data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def decode_png(data: bytes, path: str = "<PNG bytes>") -> np.ndarray:
    """`read_png` of a PNG file's bytes; `path` names it in errors."""
    header = palette = None
    idat = []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"{path}: IHDR of {len(payload)} bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3 or not payload:
                raise ValueError(f"{path}: PLTE of {len(payload)} bytes")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"{path}: unknown PNG color type {ctype}")
    channels, depths = _COLOR_TYPES[ctype]
    if (depth not in depths or compression or filter_method
            or interlace not in (0, 1) or not width or not height):
        raise ValueError(f"{path}: unsupported IHDR {header}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: image data does not inflate: {e}") from None
    samples = _decode(raw, width, height, depth, channels, interlace, path)
    return _to_rgb(samples, ctype, depth, palette, path)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """An [H, W, 3] uint8 array as the bytes of an 8-bit RGB PNG, every
    scanline under the Up filter (the byte above subtracted)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png: takes [H, W, 3] uint8, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape[:2]
    flat = img.reshape(height, width * 3)
    up = np.empty((height, width * 3 + 1), np.uint8)
    up[:, 0] = 2
    up[0, 1:] = flat[0]
    np.subtract(flat[1:], flat[:-1], out=up[1:, 1:])
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write `encode_png(img, level)` to `path`."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)
