"""The port's JPEG decoder (`utils/jpeg.py` over `csrc/host_io.cc`) against
Pillow's `Image.open(p).convert("RGB")` (libjpeg-turbo), byte for byte.

Pillow writes most of the matrix: qualities 50 / 75 / 95 at 4:4:4, 4:2:2
and 4:2:0, progressive, optimized tables, restart intervals in blocks and
in rows, grayscale, at odd sizes down to 1 x 1. Samplings Pillow does not
write (4:4:0, 4:1:1, chroma sampled 1x2 under a 2x2 luma) and the RGB
colour space (Adobe transform 0, or component ids 'R', 'G', 'B') come from
`encode_baseline`, a small baseline encoder here; Pillow decodes its files
for the reference. Then the refusals, and the committed fixtures of
`tests/data/jpeg/` against their manifest and against Pillow."""
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from faithdiff_tpu_torch.utils import jpeg as J
from faithdiff_tpu_torch.utils.png import check_image, decode_image, read_rgb

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SIZES = [(53, 37), (37, 53), (1, 1), (2, 17), (17, 2), (64, 80)]
PILLOW = {
    "q50_444": dict(quality=50, subsampling=0),
    "q50_422": dict(quality=50, subsampling=1),
    "q50_420": dict(quality=50, subsampling=2),
    "q75_444": dict(quality=75, subsampling=0),
    "q75_422": dict(quality=75, subsampling=1),
    "q75_420": dict(quality=75, subsampling=2),
    "q95_444": dict(quality=95, subsampling=0),
    "q95_422": dict(quality=95, subsampling=1),
    "q95_420": dict(quality=95, subsampling=2),
    "progressive_420": dict(quality=75, subsampling=2, progressive=True),
    "progressive_444": dict(quality=90, subsampling=0, progressive=True),
    "optimize_422": dict(quality=75, subsampling=1, optimize=True),
    "restart_blocks_3": dict(quality=75, subsampling=2, restart_marker_blocks=3),
    "restart_rows_1": dict(quality=75, subsampling=1, restart_marker_rows=1),
    "progressive_restart": dict(quality=75, subsampling=2, progressive=True,
                                restart_marker_blocks=3),
    "gray": dict(quality=80, mode="L"),
    "gray_progressive": dict(quality=80, mode="L", progressive=True),
}


def scene(hw, seed):
    """Gradients, a hard-edged block and noise: every DCT band in use."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x + 2 * y) % 64 * 4], -1) + rng.integers(-40, 40, (h, w, 3))
    img[h // 3: h // 2 + 1, w // 4: w // 2 + 1] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pillow_jpeg(img, settings) -> bytes:
    settings = dict(settings)
    mode = settings.pop("mode", "RGB")
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **settings)
    return buf.getvalue()


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(PILLOW))
def test_decoder_equals_pillow(name, hw):
    data = pillow_jpeg(scene(hw, sum(hw)), PILLOW[name])
    got = J.decode_jpeg(data)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, pillow_rgb(data))


# ---- a baseline encoder for the samplings and colour spaces Pillow does
# not write. Huffman tables: every DC category a 4-bit code, every AC
# (run, size) symbol an 8-bit code (no code is all ones); quantization by
# the quality-75 tables of Annex K.

_QY = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QC = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
               + [99] * 32)
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _quant(table, quality=75):
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255).astype(int)


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _magnitude(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker, payload):
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def encode_baseline(img, sampling, space="ycc", quality=75):
    """Baseline JPEG bytes of [H, W, 3] uint8 `img` with per-component
    (h, v) `sampling`. `space`: "ycc" (JFIF), "adobe_rgb" (an Adobe marker
    with transform 0, no conversion) or "rgb_ids" (no marker, component
    ids 'R', 'G', 'B', no conversion)."""
    h_img, w_img = img.shape[:2]
    x = img.astype(np.float64)
    if space == "ycc":
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        x = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    qt = [_quant(_QY, quality), _quant(_QC, quality)]
    ids = [82, 71, 66] if space == "rgb_ids" else [1, 2, 3]
    blocks = []
    for c, (h, v) in enumerate(sampling):
        fh, fv = hmax // h, vmax // v
        pad = np.pad(x[..., c], ((0, mcuy * 8 * vmax - h_img), (0, mcux * 8 * hmax - w_img)),
                     mode="edge")
        plane = pad.reshape(pad.shape[0] // fv, fv, pad.shape[1] // fh, fh).mean((1, 3))
        tiles = plane.reshape(plane.shape[0] // 8, 8, plane.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        coef = _DCT @ (tiles - 128) @ _DCT.T
        quant = qt[0 if c == 0 or space != "ycc" else 1].reshape(8, 8)
        blocks.append(np.round(coef / quant).astype(int).reshape(*tiles.shape[:2], 64))
    bits, pred = _Bits(), [0, 0, 0]

    def put_block(c, blk):
        zz = blk[_ZIGZAG]
        s, m = _magnitude(zz[0] - pred[c])
        pred[c] = zz[0]
        bits.put(s, 4)
        bits.put(m, s)
        run = 0
        last = max([k for k in range(1, 64) if zz[k]], default=0)
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                bits.put(_AC_SYMBOLS.index(0xF0), 8)
                run -= 16
            s, m = _magnitude(zz[k])
            bits.put(_AC_SYMBOLS.index((run << 4) | s), 8)
            bits.put(m, s)
            run = 0
        if last < 63:
            bits.put(_AC_SYMBOLS.index(0x00), 8)

    for my in range(mcuy):
        for mx in range(mcux):
            for c, (h, v) in enumerate(sampling):
                for by in range(v):
                    for bx in range(h):
                        put_block(c, blocks[c][my * v + by, mx * h + bx])
    head = b"\xff\xd8"
    if space == "ycc":
        head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif space == "adobe_rgb":
        head += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    for i, q in enumerate(qt):
        head += _segment(0xDB, bytes([i]) + bytes(q[_ZIGZAG].tolist()))
    head += _segment(0xC0, struct.pack(">BHHB", 8, h_img, w_img, 3) + b"".join(
        bytes([ids[c], (h << 4) | v, 0 if c == 0 or space != "ycc" else 1])
        for c, (h, v) in enumerate(sampling)))
    head += _segment(0xC4, b"\x00" + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
    head += _segment(0xC4, b"\x10" + bytes([0] * 7 + [162] + [0] * 8) + bytes(_AC_SYMBOLS))
    head += _segment(0xDA, b"\x03" + b"".join(bytes([i, 0]) for i in ids) + b"\x00\x3f\x00")
    return head + bits.flush() + b"\xff\xd9"


SAMPLINGS = {
    "440": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "420_chroma_1x2": [(2, 2), (1, 2), (1, 2)],
    "444": [(1, 1), (1, 1), (1, 1)],
}


@pytest.mark.parametrize("hw", [(53, 37), (16, 16), (5, 3), (40, 70)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decoder_equals_pillow_at_other_samplings(sampling, hw):
    data = encode_baseline(scene(hw, 3 * sum(hw)), SAMPLINGS[sampling])
    np.testing.assert_array_equal(J.decode_jpeg(data), pillow_rgb(data))


@pytest.mark.parametrize("space", ["adobe_rgb", "rgb_ids"])
def test_decoder_equals_pillow_in_rgb_space(space):
    data = encode_baseline(scene((29, 41), 5), SAMPLINGS["444"], space=space)
    np.testing.assert_array_equal(J.decode_jpeg(data), pillow_rgb(data))


# ---- refusals

def _with_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


@pytest.mark.parametrize("case,match", [
    ("truncated", r"x\.jpg: truncated or corrupt entropy-coded data"),
    ("cut_header", r"x\.jpg: truncated JPEG"),
    ("arithmetic", r"x\.jpg: an arithmetic-coded JPEG .*ROADMAP §1\.1"),
    ("lossless", r"x\.jpg: a lossless JPEG .*ROADMAP §1\.1"),
    ("hierarchical", r"x\.jpg: a hierarchical JPEG .*ROADMAP §1\.1"),
    ("12bit", r"x\.jpg: 12-bit samples .*ROADMAP §1\.1"),
    ("cmyk", r"x\.jpg: a CMYK / YCCK JPEG .*ROADMAP §1\.1"),
    ("no_scan", r"x\.jpg: JPEG without a frame or a scan"),
    ("not_jpeg", r"x\.jpg: not a JPEG file")])
def test_decoder_refuses(case, match):
    data = pillow_jpeg(scene((40, 48), 1), dict(quality=80))
    if case == "truncated":
        data = data[:len(data) * 3 // 4]
    elif case == "cut_header":
        data = data[:data.index(b"\xff\xda") + 4]
    elif case == "arithmetic":
        data = _with_sof(data, 0xC9)
    elif case == "lossless":
        data = _with_sof(data, 0xC3)
    elif case == "hierarchical":
        data = _with_sof(data, 0xC5)
    elif case == "12bit":
        i = data.index(b"\xff\xc0")
        data = data[:i + 4] + b"\x0c" + data[i + 5:]
    elif case == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(scene((40, 48), 1)).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif case == "no_scan":
        data = data[:data.index(b"\xff\xda")] + b"\xff\xd9"
    elif case == "not_jpeg":
        data = b"\x00" + data[1:]
    with pytest.raises(ValueError, match=match):
        J.decode_jpeg(data, "x.jpg")


def test_dispatch_by_first_bytes(tmp_path):
    """`read_rgb` / `decode_image` take a JPEG whatever its name says, and
    a PNG; `check_image` passes both and refuses other files."""
    img = scene((20, 30), 2)
    data = pillow_jpeg(img, dict(quality=90))
    (tmp_path / "photo.png").write_bytes(data)         # a JPEG named .png
    Image.fromarray(img).save(tmp_path / "real.png")
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "photo.png")), pillow_rgb(data))
    np.testing.assert_array_equal(decode_image(data), pillow_rgb(data))
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "real.png")), img)
    check_image(str(tmp_path / "photo.png"))
    check_image(str(tmp_path / "real.png"))
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match=r"x\.gif: neither a PNG nor a JPEG"):
        check_image(str(tmp_path / "x.gif"))


# ---- the committed fixtures

def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def test_fixture_manifest_is_pillows():
    """Each fixture's Pillow decode has the manifest's shape and SHA-256,
    the port's decode the same bytes; the fixtures stay small."""
    files = _manifest()["files"]
    assert set(files) == {n for n in os.listdir(FIXTURES) if n.endswith(".jpg")}
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in files) <= 1_500_000
    for name, entry in files.items():
        path = os.path.join(FIXTURES, name)
        want = np.asarray(Image.open(path).convert("RGB"))
        assert list(want.shape) == entry["shape"], name
        assert hashlib.sha256(want.tobytes()).hexdigest() == entry["rgb_sha256"], name
        np.testing.assert_array_equal(J.read_jpeg(path), want, err_msg=name)


def test_fixture_script_rebuilds_the_manifest(tmp_path):
    """`tests/make_jpeg_fixtures.py` writes the committed files again, bit
    for bit, with this Pillow."""
    import make_jpeg_fixtures

    assert make_jpeg_fixtures.main(["--out", str(tmp_path)]) == 0
    with open(tmp_path / "manifest.json") as f:
        fresh = json.load(f)
    assert fresh["files"] == _manifest()["files"]
    for name in fresh["files"]:
        assert (tmp_path / name).read_bytes() == \
            open(os.path.join(FIXTURES, name), "rb").read(), name
