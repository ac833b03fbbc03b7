"""The GroupNorm launch plan (`ops/groupnorm.plan_group_norm`) and the
kernels' schedule in plain PyTorch (`group_norm_tiled`), on the CPU.

The plan is checked over every GroupNorm shape of the full-width SDXL UNet
at UNet batch 4, 26, 30 and 50 (2, 13, 15 and 25 tiles), the VAE's and
the denoise encoder's full-resolution shapes, and odd or unaligned
shapes: 1-D grids within the card's limit, blocks that cover each element
once, and the route the shape calls for. The tile walk is held against the
plain GroupNorm and the JAX package's Pallas kernels in interpret mode, in
fp32. Adds about 10 s to tier-1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.groupnorm import _fused_group_norm_fwd
from faithdiff_tpu_torch.config import UNetConfig
from faithdiff_tpu_torch.models.layers import GroupNorm
from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
from faithdiff_tpu_torch.ops import groupnorm as gn


def _unet_shapes(batch: int, latent: int = 128):
    """[B, C, H, W] of each GroupNorm of the full-width UNet (built on the
    meta device) at one 128^2 latent tile: down block i runs at latent/2^i,
    up block i at latent/2^(2-i), the middle at latent/4, the rest at the
    latent size."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig())
    shapes = []
    for name, m in unet.named_modules():
        if not isinstance(m, GroupNorm):
            continue
        parts = name.split(".")
        if parts[0] == "down_blocks":
            side = latent >> int(parts[1])
        elif parts[0] == "up_blocks":
            side = latent >> (2 - int(parts[1]))
        elif parts[0] == "mid_block":
            side = latent >> 2
        else:
            side = latent
        shapes.append((batch, m.weight.shape[0], side, side))
    assert len(shapes) == 47
    return shapes


UNET = sorted({s for batch in (4, 26, 30, 50) for s in _unet_shapes(batch)})
# VAE encoder / decoder and denoise encoder at 1024x1536 and 2048x3072 px
VAE = [(1, 128, 1024, 1536), (1, 256, 1024, 1536), (1, 256, 512, 768),
       (1, 512, 512, 768), (1, 512, 256, 384), (1, 512, 128, 192),
       (1, 128, 2048, 3072), (1, 256, 2048, 3072)]
# (shape, itemsize, groups, aligned): odd HW, unaligned x, fp32, fp16
ODD = [((1, 32, 5, 7), 2, 8, True), ((1, 96, 33, 31), 2, 32, True),
       ((2, 64, 16, 16), 2, 32, False), ((2, 64, 16, 16), 4, 32, True),
       ((1, 96, 33, 31), 2, 32, False), ((3, 64, 6, 6), 4, 32, True),
       ((1, 32, 1, 1), 2, 32, True), ((30, 2560, 32, 32), 4, 32, True),
       ((1, 8, 384, 384), 4, 2, True)]
CASES = ([(s, 2, 32, True) for s in UNET + VAE] + ODD)


def _fits(length: int, hw: int, itemsize: int, aligned: bool) -> bool:
    """What calls for the single-pass route: bulk copies can move the group
    and the group fits the largest cluster of the largest slices."""
    return (aligned and hw * itemsize % 16 == 0
            and length * itemsize <= gn.FUSED_MAX_CLUSTER * gn.FUSED_SLICE_BYTES)


def _cover(n_blocks: int, size: int, total: int):
    """Each block's range [i*size, min(total, (i+1)*size)); all must be
    non-empty and together hold [0, total) once."""
    seen = np.zeros(total, np.int64)
    for i in range(n_blocks):
        lo, hi = i * size, min(total, (i + 1) * size)
        assert lo < hi, f"block {i} of {n_blocks} is empty"
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,itemsize,groups,aligned", CASES)
def test_plan_covers_each_element_once_within_the_grid(shape, itemsize, groups,
                                                       aligned):
    p = gn.plan_group_norm(shape, itemsize, groups, aligned)
    b, c = shape[:2]
    hw = int(np.prod(shape[2:]))
    length = c // groups * hw
    vec = 16 // itemsize
    assert p.route == ("fused" if _fits(length, hw, itemsize, aligned)
                       else "two_pass")
    assert p.counters == (("group_norm_fused",) if p.route == "fused"
                          else ("group_norm_stats", "group_norm_apply"))
    # two passes, planned for every shape: 1-D grids, chunks cover each
    # group and segments each channel once
    assert p.stats_grid == b * groups * p.n_chunks <= gn.MAX_GRID
    assert p.apply_grid == b * c * p.n_segments <= gn.MAX_GRID
    assert p.n_chunks <= max(gn._MAX_CHUNKS, 1) and p.chunk % vec == 0
    assert p.vec == (aligned and hw % vec == 0)
    _cover(p.n_chunks, p.chunk, length)
    _cover(p.n_segments, p.segment, hw)
    if p.route == "two_pass":
        assert (p.cluster, p.fused_grid, p.smem_bytes) == (0, 0, 0)
        return
    # one pass: a power-of-two cluster (non-portable above 8) whose slices
    # hold the group; each slice and bulk copy a whole number of 16-byte
    # vectors, at most FUSED_PIECES copies a block, in shared memory
    assert p.cluster in (1, 2, 4, 8, 16)
    assert p.fused_grid == b * groups * p.cluster <= gn.MAX_GRID
    assert p.slice_len * itemsize <= gn.FUSED_SLICE_BYTES
    assert p.slice_len * itemsize % 16 == 0 and p.piece_len * itemsize % 16 == 0
    assert -(-p.slice_len // p.piece_len) <= gn.FUSED_PIECES
    assert p.smem_bytes == gn.fused_smem_bytes(p.slice_len, itemsize,
                                               c // groups) <= gn.SMEM_LIMIT
    _cover(p.cluster, p.slice_len, length)
    for rank in range(p.cluster):
        _cover(-(-min(p.slice_len, length - rank * p.slice_len) // p.piece_len),
               p.piece_len, min(p.slice_len, length - rank * p.slice_len))


def test_every_unet_group_norm_is_one_launch_at_any_batch():
    """The largest UNet group, 30 channels at 128^2 (960 KB in bf16), fits
    one cluster; batch only multiplies the clusters."""
    for shape in UNET:
        assert gn.plan_group_norm(shape, 2, 32).route == "fused", shape
    assert max(s[1] // 32 * s[2] * s[3] * 2 for s in UNET) == 960 * 1024


# (shape, groups, act, with_add, routes); FUSED_SLICE_BYTES is cut in some
# cases so that a small group spreads over many ranks
TILED = [((2, 64, 16, 16), 32, "silu", True, ("fused", "two_pass"), None),
         ((1, 96, 10, 6), 32, None, False, ("fused", "two_pass"), None),
         ((1, 64, 128, 128), 32, "silu", True, ("fused", "two_pass"), None),
         ((2, 32, 16, 24), 8, None, True, ("fused",), 512),
         ((1, 48, 20, 20), 16, "silu", False, ("fused",), 512),
         ((2, 32, 5, 7), 8, "silu", True, ("two_pass",), None),
         ((1, 8, 384, 384), 2, None, True, ("two_pass",), None)]


@pytest.mark.parametrize("shape,groups,act,with_add,routes,slice_bytes", TILED)
def test_tile_walk_matches_plain_and_pallas_interpret(monkeypatch, shape, groups,
                                                      act, with_add, routes,
                                                      slice_bytes):
    if slice_bytes is not None:
        monkeypatch.setattr(gn, "FUSED_SLICE_BYTES", slice_bytes)
    rng = np.random.default_rng(5)
    b, c = shape[:2]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)     # NCHW
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    add = ((rng.standard_normal((b, c)) * 0.5).astype(np.float32)
           if with_add else None)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    tadd = None if add is None else torch.from_numpy(add)
    plain = gn.group_norm_reference(tx, ts, tb, groups, 1e-6, act, tadd)
    pallas = np.asarray(_fused_group_norm_fwd(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(scale),
        jnp.asarray(bias), None if add is None else jnp.asarray(add), groups,
        1e-6, act, interpret=True)).transpose(0, 3, 1, 2)
    plan = gn.plan_group_norm(shape, 4, groups)
    if slice_bytes is not None:
        assert plan.cluster > 2, plan           # many ranks to fold
    for route in routes:
        ours = gn.group_norm_tiled(tx, ts, tb, groups, 1e-6, act, tadd,
                                   route=route)
        # fp32 sums in another order on each side (the JAX package's own
        # fused-vs-reference test allows 1e-5)
        np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-5)
