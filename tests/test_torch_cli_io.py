"""The restore CLI's host I/O against the libraries the JAX CLI uses: the
port's safetensors reader and writer against `safetensors`, its PNG
decoder and encoder against PIL, its LANCZOS / BICUBIC resample against
PIL's `Image.resize` (bit for bit), and its HDR effect against the JAX
package's `create_hdr_effect`."""
import struct
import zlib

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
from PIL import Image

from faithdiff_tpu.utils.image import create_hdr_effect as jax_hdr
from faithdiff_tpu_torch.utils import png
from faithdiff_tpu_torch.utils.image import create_hdr_effect
from faithdiff_tpu_torch.utils.resample import resize_bicubic, resize_lanczos
from faithdiff_tpu_torch.utils.safetensors import (load_file, read_metadata,
                                                   save_file)

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64,
          torch.int32, torch.uint8]
META = {"format": "pt", "note": "made by a test"}


def _tensors(dtype):
    g = torch.Generator().manual_seed(0)

    def make(*shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g).to(dtype)
        return torch.randint(0, 250, shape, generator=g).to(dtype)

    # a byte tensor first in name order: the writers must still align
    # every buffer to its element size
    return {"a.bytes": torch.arange(5, dtype=torch.uint8), "b.w": make(3, 4),
            "c.scalar": make(), "d.empty": make(0, 2), "e.x": make(2, 3, 5)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_port_writes_library_reads(tmp_path, dtype):
    ts = _tensors(dtype)
    path = str(tmp_path / "m.safetensors")
    save_file(ts, path, metadata=META)
    got = safetensors.torch.load_file(path)
    assert set(got) == set(ts)
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with safetensors.safe_open(path, "pt") as f:
        assert f.metadata() == META


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_library_writes_port_reads(tmp_path, dtype):
    ts = _tensors(dtype)
    path = str(tmp_path / "m.safetensors")
    safetensors.torch.save_file(ts, path, metadata=META)
    got = load_file(path)
    assert set(got) == set(ts)
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert read_metadata(path) == META


def test_safetensors_numpy_writer_and_malformed_files(tmp_path):
    """A file of the numpy writer (what the JAX package's loader reads)
    without metadata; truncated or over-long files raise."""
    rng = np.random.default_rng(1)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "h": rng.standard_normal(7).astype(np.float16)}
    path = str(tmp_path / "n.safetensors")
    safetensors.numpy.save_file(arrays, path)
    got = load_file(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert read_metadata(path) == {}
    data = open(path, "rb").read()
    for bad in (data[:-3], data + b"\0" * 8, data[:6]):
        (tmp_path / "bad.safetensors").write_bytes(bad)
        with pytest.raises(ValueError):
            load_file(str(tmp_path / "bad.safetensors"))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(2)
RGB = RNG.integers(0, 256, (23, 37, 3), dtype=np.uint8)


def _pil_images():
    out = {"RGB": Image.fromarray(RGB),
           "RGBA": Image.fromarray(RNG.integers(0, 256, (23, 37, 4), dtype=np.uint8)),
           "L": Image.fromarray(RGB).convert("L"),
           "LA": Image.fromarray(RGB).convert("LA"),
           "1": Image.fromarray(RGB).convert("1")}
    for bits in (1, 2, 4, 8):
        im = Image.fromarray(RNG.integers(0, 2 ** bits, (23, 37), dtype=np.uint8), "P")
        im.putpalette(RNG.integers(0, 256, 3 * 2 ** bits).tolist())
        out[f"P{bits}"] = (im, bits)
    return out


PIL_IMAGES = _pil_images()


@pytest.mark.parametrize("mode", sorted(PIL_IMAGES))
def test_png_decode_matches_pil(tmp_path, mode):
    """Files PIL writes in each mode (gray at 1 and 8 bits, gray + alpha,
    RGB, RGBA, palettes at 1/2/4/8 bits) decode to `convert("RGB")`."""
    im = PIL_IMAGES[mode]
    path = str(tmp_path / "x.png")
    if isinstance(im, tuple):
        im, bits = im
        im.save(path, bits=bits)
        assert open(path, "rb").read()[24] == bits      # IHDR bit depth
    else:
        im.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(img, filters, depth=8, ctype=2, interlace=0):
    """A PNG whose scanline r is filtered with filters[r] (PNG's five)."""
    h = img.shape[0]
    flat = img.reshape(h, -1).astype(np.int32)
    bpp = img.shape[2] if img.ndim == 3 else 1
    lines = []
    for r in range(h):
        x = flat[r]
        up = flat[r - 1] if r else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        pred = [0 * x, left, up, (left + up) >> 1, _paeth(left, up, ul)][filters[r]]
        lines.append(bytes([filters[r]]) + ((x - pred) & 255).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, interlace)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(lines)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth",
                                     "mixed"])
def test_png_filters_match_pil(tmp_path, filters):
    """Every scanline filter, alone and mixed row by row, on RGB and RGBA."""
    kinds = ["none", "sub", "up", "average", "paeth"]
    for img, ctype in ((RGB, 2), (RNG.integers(0, 256, (9, 11, 4), dtype=np.uint8), 6)):
        h = img.shape[0]
        f = (RNG.integers(0, 5, h).tolist() if filters == "mixed"
             else [kinds.index(filters)] * h)
        path = tmp_path / "f.png"
        path.write_bytes(_encode(img, f, ctype=ctype))
        np.testing.assert_array_equal(
            png.read_png(str(path)), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("shape", [(1, 1), (23, 37), (64, 48)])
def test_png_encoder_read_by_pil(tmp_path, shape):
    img = RNG.integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_interlaced_16_bit_and_corrupt(tmp_path):
    """Interlaced and 16-bit files decode (`test_torch_png_formats.py`);
    what is refused is an interlace method past Adam7, a 16-bit palette,
    and a corrupt chunk."""
    path = tmp_path / "i.png"
    path.write_bytes(_encode(RGB, [0] * RGB.shape[0], interlace=2))
    with pytest.raises(ValueError, match="unsupported IHDR"):
        png.read_png(str(path))
    pal = RNG.integers(0, 256, (5, 6, 2), dtype=np.uint8)
    data = bytearray(_encode(pal, [0] * 5, depth=16, ctype=3))
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="unsupported IHDR"):
        png.read_png(str(path))
    data = bytearray(_encode(RGB, [0] * RGB.shape[0]))
    data[40] ^= 0xFF                                  # inside IDAT
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        png.read_png(str(path))


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

SIZES = [(13, 17), (31, 40), (64, 48), (5, 3)]


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("upscale", [1, 2, 4])
def test_resize_lanczos_is_pillow(hw, upscale):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    size = (hw[1] * upscale, hw[0] * upscale)
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(img, size), want)


@pytest.mark.parametrize("size", [(7, 9), (21, 1), (50, 33), (1, 1)], ids=str)
@pytest.mark.parametrize("kind", ["lanczos", "bicubic"])
def test_resize_odd_sizes_are_pillow(size, kind):
    """Odd targets, shrinking and stretching per axis; BICUBIC (the
    captioner's, moved to `utils/resample.py`) unchanged."""
    img = np.random.default_rng(3).integers(0, 256, (31, 40, 3), dtype=np.uint8)
    fn, flt = ((resize_lanczos, Image.LANCZOS) if kind == "lanczos"
               else (resize_bicubic, Image.BICUBIC))
    want = np.asarray(Image.fromarray(img).resize(size, flt))
    np.testing.assert_array_equal(fn(img, size), want)


# ---------------------------------------------------------------------------
# HDR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,hdr", [((37, 53), 0.0), ((37, 53), 0.5),
                                    ((37, 53), 1.0), ((16, 16), 0.2)], ids=str)
def test_create_hdr_effect_matches_jax(hw, hdr):
    """Mertens fusion of 9 exposures in torch fp32 against the JAX
    package's: within 1 uint8 level (both truncate a float * 255)."""
    img = np.random.default_rng(4).integers(0, 256, hw + (3,), dtype=np.uint8)
    want = jax_hdr(img, hdr)
    got = create_hdr_effect(img, hdr, device="cpu")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("hw", [(15, 31), (16, 16), (9, 8)], ids=str)
def test_image_size_and_conversions_match_jax(hw):
    """check_image_size's replicate pad to /8 and the uint8 <-> [0, 1]
    conversions, against the JAX package's (numpy on both sides)."""
    from faithdiff_tpu.utils import image as jimage
    from faithdiff_tpu_torch.utils import image as timage

    img = np.random.default_rng(5).integers(0, 256, hw + (3,), dtype=np.uint8)
    for got, want in zip(timage.check_image_size(img),
                         jimage.check_image_size(img)):
        np.testing.assert_array_equal(got, want)
    arr = timage.image_to_array(img)
    np.testing.assert_array_equal(arr, jimage.image_to_array(img))
    np.testing.assert_array_equal(timage.image_to_array(img[..., 0]),
                                  jimage.image_to_array(img[..., 0]))
    x = np.random.default_rng(6).uniform(-0.2, 1.2, (1,) + hw + (3,))
    np.testing.assert_array_equal(timage.array_to_image(x),
                                  jimage.array_to_image(x))
    np.testing.assert_array_equal(timage.array_to_image(arr), img)
