"""The port's PNG reader (`faithdiff_tpu_torch/utils/png.py`) on 16-bit
and Adam7-interlaced files, byte for byte against Pillow's
`Image.open(p).convert("RGB")`, which is what the JAX CLI reads
(`faithdiff_tpu/cli.py:166`). The files are written here: every color
type at every depth it allows, interlaced and not, palettes with and
without `tRNS`, every scanline filter mixed row by row, at odd sizes that
leave some Adam7 passes empty. Pillow clips 16-bit gray (`I;16`) to 255
and keeps the high byte of 16-bit RGB, RGBA and gray + alpha."""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from faithdiff_tpu_torch.utils import png

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples, depth):
    """[h, w, ch] samples -> [h, rowbytes] bytes (big-endian, MSB first)."""
    h, w, ch = samples.shape
    if depth == 16:
        s = samples.astype(np.uint16).reshape(h, w * ch)
        return np.stack([s >> 8, s & 255], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return samples.reshape(h, w * ch).astype(np.uint8)
    per = 8 // depth
    vals = samples[..., 0].astype(np.uint8)
    pad = (-w) % per
    vals = np.pad(vals, ((0, 0), (0, pad)))
    vals = vals.reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(vals << shifts, axis=2).astype(np.uint8)


def _filtered(rows, bpp, rng):
    """Scanlines, each under a random one of PNG's five filters."""
    out = []
    flat = rows.astype(np.int32)
    for r in range(flat.shape[0]):
        x = flat[r]
        up = flat[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = int(rng.integers(0, 5))
        pred = [0 * x, left, up, (left + up) >> 1, _paeth(left, up, ul)][f]
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(out)


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _write(path, samples, depth, ctype, interlace, rng, palette=None,
           trns=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for r0, c0, dr, dc in passes:
        sub = samples[r0::dr, c0::dc]
        if sub.size:
            data += _filtered(_pack(sub, depth), bpp, rng)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = _chunk(b"IHDR", ihdr)
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    path.write_bytes(png._SIGNATURE + body + _chunk(b"IDAT", zlib.compress(data))
                     + _chunk(b"IEND", b""))


# every 16-bit layout, interlaced or not, and Adam7 at every depth (the
# 8-bit and lower non-interlaced files: `test_torch_cli_io.py`)
CASES = [(ctype, depth, interlace)
         for ctype, (_, depths) in sorted(png._COLOR_TYPES.items())
         for depth in depths for interlace in (0, 1)
         if depth == 16 or interlace]
# odd sizes: 1x1 and 3x2 leave Adam7 passes empty, 13x11 fills all seven
SIZES = [(1, 1), (3, 2), (13, 11)]


def _samples(rng, hw, ctype, depth):
    hi = 2 ** depth
    s = rng.integers(0, hi, hw + (CHANNELS[ctype],))
    if depth == 16:
        # some 16-bit gray below 256, where Pillow's clip leaves it as is
        s[::2] %= 256
    return s


@pytest.mark.parametrize("ctype,depth,interlace", CASES,
                         ids=lambda v: str(v))
def test_png_formats_match_pillow(tmp_path, ctype, depth, interlace):
    rng = np.random.default_rng(100 * ctype + depth + interlace)
    for hw in SIZES:
        samples = _samples(rng, hw, ctype, depth)
        palette = trns = None
        if ctype == 3:
            palette = rng.integers(0, 256, (2 ** depth, 3))
            trns = bytes(rng.integers(0, 256, 2 ** depth // 2 + 1).astype(np.uint8))
        path = tmp_path / f"{hw[0]}x{hw[1]}.png"
        _write(path, samples, depth, ctype, interlace, rng, palette, trns)
        want = np.asarray(Image.open(path).convert("RGB"))
        got = png.read_png(str(path))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_16_bit_rule(tmp_path, ctype):
    """The rule itself on known values: gray clips, the rest shift."""
    rng = np.random.default_rng(ctype)
    samples = np.full((1, 3, CHANNELS[ctype]), 0, np.int64)
    samples[0, :, 0] = (200, 255, 4660)         # 4660 = 0x1234
    _write(tmp_path / "k.png", samples, 16, ctype, 0, rng)
    got = png.read_png(str(tmp_path / "k.png"))[0, :, 0]
    want = [200, 255, 255] if ctype == 0 else [0, 0, 0x12]
    np.testing.assert_array_equal(got, want)
