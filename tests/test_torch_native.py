"""`faithdiff_tpu_torch/native.py` (over the port's `csrc/host_io.cc`)
against `faithdiff_tpu.native` (over `native/faithdiff_io.cc`, which links
libjpeg and libpng) and the port's `pipelines/tiling.merge_tiles`."""
import numpy as np
import pytest
import torch
from PIL import Image

import faithdiff_tpu.native as jn
from faithdiff_tpu.pipelines.tiling import compute_tile_layout as jax_layout
from faithdiff_tpu_torch import native as tn
from faithdiff_tpu_torch.pipelines.tiling import (compute_tile_layout,
                                                  merge_tiles, split_tiles)

SIZES = [(64, 48), (32, 24), (100, 70), (33, 77), (7, 5)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    out = []
    for i, (ext, kw) in enumerate([("png", {}), ("jpg", dict(quality=85)),
                                   ("jpg", dict(quality=70, progressive=True)),
                                   ("png", {}), ("jpeg", dict(quality=90, subsampling=0))]):
        arr = rng.integers(0, 255, (48 + 3 * i, 64 - 5 * i, 3), np.uint8)
        path = str(d / f"img{i}.{ext}")
        Image.fromarray(arr).save(path, **kw)
        out.append(path)
    return out


@pytest.fixture(scope="module")
def jax_native():
    if not jn.native_available():
        pytest.skip("the JAX package's native library did not build here")
    return jn


@pytest.mark.parametrize("wh", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_resize_matches_jax_native(files, jax_native, wh):
    for path in files:
        np.testing.assert_allclose(tn.decode_resize(path, *wh),
                                   jax_native.decode_resize(path, *wh),
                                   rtol=0, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_decode_batch_matches_jax_native_and_single_decodes(files, jax_native,
                                                            threads):
    paths = files * 3
    got = tn.decode_batch(paths, 40, 30, num_threads=threads)
    assert got.shape == (len(paths), 30, 40, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_native.decode_batch(paths, 40, 30, threads),
                               rtol=0, atol=1e-6)
    for i, path in enumerate(files):
        np.testing.assert_array_equal(got[i], tn.decode_resize(path, 40, 30))
    assert tn.decode_batch([], 40, 30).shape == (0, 30, 40, 3)


def test_decode_resize_same_size_is_the_decode(files):
    """At the image's own size the resize is the identity: the decode / 255
    (JPEG as Pillow decodes it, PNG losslessly)."""
    for path in files:
        want = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        got = tn.decode_resize(path, want.shape[1], want.shape[0])
        np.testing.assert_array_equal(got, want)


def test_missing_or_bad_files_raise(files, tmp_path):
    with pytest.raises(FileNotFoundError):
        tn.decode_resize("/nonexistent/file.png", 8, 8)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(open(files[1], "rb").read()[:200])
    with pytest.raises(ValueError, match=r"1 of 2 files failed; .*bad\.jpg: truncated"):
        tn.decode_batch([files[0], str(bad)], 8, 8)
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="not a PNG file"):
        tn.decode_resize(str(junk), 8, 8)


@pytest.mark.parametrize("hw,tile", [((64, 96), (32, 32)), ((80, 72), (48, 40))])
def test_tile_merge_host_matches_jax_and_merge_tiles(jax_native, hw, tile):
    """The Gaussian merge against the JAX module's (same arithmetic: equal
    bits) and the port's `merge_tiles` on the same tiles (within 1e-5)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4) + hw).astype(np.float32)
    lay = compute_tile_layout(*hw, tile, overlap=0.5)
    assert lay.offsets == jax_layout(*hw, tile, overlap=0.5).offsets
    tiles = split_tiles(torch.from_numpy(x), lay)             # [T, C, k1, k2]
    want = merge_tiles(tiles, lay)[0].permute(1, 2, 0).numpy()
    tiles_hwc = tiles.permute(0, 2, 3, 1).numpy()
    offsets = np.asarray(lay.offsets, np.int32)
    got = tn.tile_merge_host(tiles_hwc, offsets, hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, jax_native.tile_merge_host(tiles_hwc, offsets, hw))


def test_tile_merge_host_refuses_tiles_off_the_canvas():
    with pytest.raises(ValueError, match="leave the 16x16 canvas"):
        tn.tile_merge_host(np.zeros((1, 8, 8, 3), np.float32), np.array([[10, 0]]),
                           (16, 16))

