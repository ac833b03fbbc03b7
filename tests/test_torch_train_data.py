"""The port's training data (`faithdiff_tpu_torch/data/`,
`utils/resample.py`, `training/text_embeds.py`, the runner's
`_dataset_batches`) against the JAX package's, which reads through PIL,
on seeded 8-bit PNG pairs and captions, and on JPEG pairs: every array
and caption exactly equal."""
import argparse
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from faithdiff_tpu.data import dataset as jax_ds
from faithdiff_tpu.training import runner as jax_runner
from faithdiff_tpu.training import text_embeds as jax_te
from faithdiff_tpu_torch.data import dataset as port_ds
from faithdiff_tpu_torch.training import runner as port_runner
from faithdiff_tpu_torch.training import text_embeds as port_te
from faithdiff_tpu_torch.utils.resample import (resize_bilinear,
                                                resize_nearest)

RES = 64            # HR crop; LR crop 16


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Six HR / LR PNG pairs (LR 13x17 up to 45x38, HR 4x), captions, and
    an .npz embed dir from the port's `precompute_embeds`."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    dirs = {k: root / k for k in ("hr", "lr", "cap", "emb")}
    for d in dirs.values():
        d.mkdir()
    sizes = [(13, 17), (20, 20), (45, 38), (16, 31), (30, 16), (9, 12)]
    for i, (h, w) in enumerate(sizes):
        lr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        hr = rng.integers(0, 256, (4 * h, 4 * w, 3), dtype=np.uint8)
        Image.fromarray(lr).save(dirs["lr"] / f"s{i}.png")
        Image.fromarray(hr).save(dirs["hr"] / f"s{i}.png")
        (dirs["cap"] / f"s{i}.txt").write_text(
            f"The image shows house {i}. A cat sits on step {i}. The sky. "
            "More text.")
    (dirs["hr"] / "extra.png").write_bytes(b"")      # no LR: not a pair

    def tokenize(text):
        ids = np.zeros((1, 77), np.int64)
        ids[0, :len(text)] = [ord(c) % 64 for c in text[:77]]
        return ids, ids + 1

    def encode(ids_1, ids_2):
        return (np.tile(ids_1[..., None] * 0.5, (1, 1, 8)).astype(np.float32),
                ids_2[:, :4].astype(np.float32))

    files = sorted(str(p) for p in dirs["cap"].iterdir())
    port_te.precompute_embeds(files, str(dirs["emb"]), tokenize, encode)
    return {k: str(v) for k, v in dirs.items()}


def _assert_sample_equal(a, b):
    np.testing.assert_array_equal(a.hr, b.hr)
    np.testing.assert_array_equal(a.lq, b.lq)
    assert (a.caption, a.original_size, a.crop_coords, a.target_size) == \
        (b.caption, b.original_size, b.crop_coords, b.target_size)


def test_discover_pairs_matches_jax(pairs):
    assert port_ds.discover_pairs(pairs["hr"], pairs["lr"], pairs["cap"]) == \
        jax_ds.discover_pairs(pairs["hr"], pairs["lr"], pairs["cap"])
    assert port_ds.discover_pairs(pairs["hr"], pairs["lr"]) == \
        jax_ds.discover_pairs(pairs["hr"], pairs["lr"])


def test_dataset_draws_match_jax(pairs):
    hr, lr, caps = jax_ds.discover_pairs(pairs["hr"], pairs["lr"], pairs["cap"])
    face = [i % 3 == 0 for i in range(len(hr))]
    kw = dict(is_face=face, resolution=RES, seed=3)
    jd = jax_ds.LocalPairedDataset(hr, lr, caps, **kw)
    pd = port_ds.LocalPairedDataset(hr, lr, caps, **kw)
    samples = []
    for draw in range(20):
        i = draw % len(hr)
        a = jd.__getitem__(i, rng=random.Random(draw))
        b = pd.__getitem__(i, rng=random.Random(draw))
        _assert_sample_equal(a, b)
        samples.append((a, b))
    # the datasets' own rng, in call order
    for i in range(len(hr)):
        _assert_sample_equal(jd[i], pd[i])
    ja, pa = jax_ds.collate([s[0] for s in samples]), \
        port_ds.collate([s[1] for s in samples])
    assert ja.keys() == pa.keys() and ja["captions"] == pa["captions"]
    for k in ("hr", "lq", "add_time_ids"):
        np.testing.assert_array_equal(ja[k], pa[k])
    # the face branch's BICUBIC resizes ran: an original size of 4x 128-192
    assert any(s[1].original_size[0] >= 512 for s in samples)


def test_trim_caption_matches_jax():
    for text in ["a b c d e. f g. h", "one two", "", "x y z w. v. u. t"]:
        assert port_ds.trim_caption(text) == jax_ds.trim_caption(text)


def test_jpeg_pairs_raise(tmp_path):
    """JPEG pairs give the JAX dataset's samples (both decode as Pillow
    does); only a JPEG the port's decoder does not take raises (CMYK:
    ROADMAP §1.1)."""
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 256, (88, 72, 3), dtype=np.uint8)).save(
        tmp_path / "hr.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (22, 18, 3), dtype=np.uint8)).save(
        tmp_path / "lr.jpg", quality=80, subsampling=0)
    hr, lr = [str(tmp_path / "hr.jpg")], [str(tmp_path / "lr.jpg")]
    jd = jax_ds.LocalPairedDataset(hr, lr, resolution=RES, seed=2)
    pd = port_ds.LocalPairedDataset(hr, lr, resolution=RES, seed=2)
    for draw in range(4):
        _assert_sample_equal(jd.__getitem__(0, rng=random.Random(draw)),
                             pd.__getitem__(0, rng=random.Random(draw)))
    Image.new("CMYK", (8, 8)).save(tmp_path / "a.jpg")
    ds = port_ds.LocalPairedDataset([str(tmp_path / "a.jpg")],
                                    [str(tmp_path / "a.jpg")], resolution=16)
    with pytest.raises(ValueError, match="ROADMAP §1.1"):
        ds[0]


@pytest.mark.parametrize("fn,method", [(resize_nearest, Image.NEAREST),
                                       (resize_bilinear, Image.BILINEAR)])
@pytest.mark.parametrize("src,dst", [((37, 53), (128, 96)), ((37, 53), (11, 7)),
                                     ((64, 64), (64, 192)), ((5, 9), (17, 23)),
                                     ((191, 143), (143, 191))])
def test_resamplers_are_pillow_exact(fn, method, src, dst):
    img = np.random.default_rng(sum(src + dst)).integers(
        0, 256, src + (3,), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(dst, method))
    np.testing.assert_array_equal(fn(img, dst), ref)


def _args(pairs, workers):
    return argparse.Namespace(
        hr_dir=pairs["hr"], lr_dir=pairs["lr"], caption_dir=pairs["cap"],
        embeds_dir=pairs["emb"], text_encoder_dir=None, tokenizer_dir=None,
        resolution=RES, seed=5, train_batch_size=3,
        dataloader_workers=workers, prefetch_depth=2)


@pytest.mark.parametrize("workers", [0, 2, 4])
def test_dataset_batches_match_jax(pairs, workers):
    args = _args(pairs, workers)
    jb = jax_runner._dataset_batches(args, 8, 4)
    pb = port_runner._dataset_batches(args, 8, 4)
    for _ in range(4):
        a, b = next(jb), next(pb)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    jb.close()
    pb.close()


def test_embed_provider_from_dir_matches_jax(pairs):
    jp = jax_te.PromptEmbedProvider.from_dir(pairs["emb"])
    pp = port_te.PromptEmbedProvider.from_dir(pairs["emb"])
    stems, caps = ["s0", "s3", "s1"], ["x", "", "y"]
    for a, b in zip(jp.batch(stems, caps), pp.batch(stems, caps)):
        np.testing.assert_array_equal(a, b)
    assert pp.null_fraction == jp.null_fraction == 1 / 3
    with pytest.raises(FileNotFoundError):
        port_te.PromptEmbedProvider.from_dir(pairs["cap"])


def test_embed_provider_from_towers_and_zeros_match_jax():
    calls = []

    def tokenize(text):
        calls.append(text)
        return np.full((1, 77), len(text)), np.full((1, 77), 2 * len(text))

    def encode(i1, i2):
        return (torch.full((1, 77, 4), float(i1[0, 0])),
                torch.full((1, 3), float(i2[0, 0])))

    pp = port_te.PromptEmbedProvider.from_towers(tokenize, encode)
    jp = jax_te.PromptEmbedProvider.from_towers(
        tokenize, lambda a, b: tuple(t.numpy() for t in encode(a, b)))
    for a, b in zip(jp.batch(["a", "b", "c"], ["hi", "", "hi"]),
                    pp.batch(["a", "b", "c"], ["hi", "", "hi"])):
        np.testing.assert_array_equal(a, b)
    assert calls == ["hi", "", "hi", ""]          # one encode per caption, each
    for a, b in zip(jax_te.PromptEmbedProvider.zeros(8, 4).batch(["a"], ["x"]),
                    port_te.PromptEmbedProvider.zeros(8, 4).batch(["a"], ["x"])):
        np.testing.assert_array_equal(a, b)
