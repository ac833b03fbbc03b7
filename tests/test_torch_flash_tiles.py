"""The flash kernels' tile schedule in plain PyTorch
(`ops/attention.py::flash_attention_tiled`: 128-row q blocks of two 64-row
groups, K/V tiles of 64 or 128 rows, the causal tile bound, partial-tile
masking, base 2 / base e, the bf16 roundings of q and p) against the JAX
package's Pallas flash kernel in interpret mode and against the plain
attention at ragged lengths; and the pure functions that turn a tensor's
shape and strides into the TMA tensor maps' geometry. Inputs come from
numpy and go to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.attention import _flash_attention_fwd_impl
from faithdiff_tpu_torch.ops.attention import (BLOCK_K, BLOCK_Q, GROUP_ROWS,
                                               PANEL_COLS, TmaGeometry,
                                               _geometry_argument,
                                               attention_reference,
                                               bhsd_geometry,
                                               flash_attention_tiled, kv_tiles,
                                               packed_geometry)
from faithdiff_tpu_torch.ops.attention_variants import (
    VARIANTS, attention_variant_reference)

LENGTHS = (1, 63, 77, 129, 200, 257)
# (q_len, kv_len, causal): every length on both sides, causal on the squares
RAGGED = ([(a, b, False) for a, b in zip(LENGTHS, LENGTHS[1:] + LENGTHS[:1])]
          + [(n, n, True) for n in LENGTHS])


def _qkv(q_len, kv_len, d, seed, heads=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, heads, n, d))
                             .astype(np.float32))
            for n in (q_len, kv_len, kv_len)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tile_walk_matches_pallas_interpret(d, causal):
    q, k, v = _qkv(256, 256, d, 6)
    scale = d ** -0.5
    ours = flash_attention_tiled(q, k, v, scale, causal).numpy()
    pallas = _flash_attention_fwd_impl(
        *(jnp.asarray(a.numpy()) for a in (q, k, v)), scale=scale,
        causal=causal, block_q=128, block_k=128, interpret=True)
    # fp32 on both sides, the same base-2 online softmax over the same
    # 128-row tiles: rounding only (the Pallas kernel's own test allows 2e-5)
    np.testing.assert_allclose(ours, np.asarray(pallas), atol=2e-5)


@pytest.mark.parametrize("base2,block_k", VARIANTS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_len,kv_len,causal", RAGGED)
def test_tile_walk_matches_plain_at_ragged_lengths(q_len, kv_len, causal, d,
                                                   base2, block_k):
    q, k, v = _qkv(q_len, kv_len, d, 11)
    scale = d ** -0.5
    ours = flash_attention_tiled(q, k, v, scale, causal, base2=base2,
                                 block_k=block_k)
    ref = attention_reference(q, k, v, scale, causal)
    # fp32: an online softmax over tiles against one softmax, rounding only
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-5)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    ours = flash_attention_tiled(qb, kb, vb, scale, causal, base2=base2,
                                 block_k=block_k).float()
    ref = attention_reference(qb, kb, vb, scale, causal).float()
    # bf16: the kernels' tolerance (q is rounded after the scale fold and p
    # before p.v, at other points than in the plain version)
    assert bool(((ours - ref).abs() <= 1e-2 + 8e-3 * ref.abs()).all())


@pytest.mark.parametrize("base2", [False, True])
def test_tile_walk_rounds_as_its_variant(base2):
    """In bf16 the base-2 fold rounds q * scale * log2 e: the walk agrees
    with the one-pass form of its own variant."""
    q, k, v = (t.bfloat16() for t in _qkv(200, 257, 64, 12))
    ours = flash_attention_tiled(q, k, v, 0.125, base2=base2).float()
    want = attention_variant_reference(q[0], k[0], v[0], 0.125, base2).float()
    # p is rounded to bf16 against a running max instead of the final one,
    # and fp32 sums run in another order: a few bf16 steps of |o| << 1
    np.testing.assert_allclose(ours[0].numpy(), want.numpy(), rtol=2 ** -6,
                               atol=2e-3)


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("n", [1, 63, 77, 128, 129, 200, 257, 640])
def test_causal_walk_visits_the_closed_form_tile_count(n, block_k):
    """Under the causal mask a block visits exactly the K/V tiles that
    hold an unmasked score for one of its rows, the number `kv_tiles`
    (and the kernel) computes in closed form."""
    q, k, v = _qkv(n, n, 64, 13, heads=1)
    visited = []
    flash_attention_tiled(q, k, v, 0.125, True, block_k=block_k, visited=visited)
    mask = torch.ones((n, n), dtype=torch.bool).tril()
    for q0 in range(0, n, BLOCK_Q):
        live = [k0 for k0 in range(0, n, block_k)
                if bool(mask[q0:q0 + BLOCK_Q, k0:k0 + block_k].any())]
        assert [k0 for b0, k0 in visited if b0 == q0] == live
        assert kv_tiles(q0, n, True, BLOCK_Q, block_k) == len(live)
        assert kv_tiles(q0, n, False, BLOCK_Q, block_k) == -(-n // block_k)
    assert len(visited) == sum(kv_tiles(q0, n, True, BLOCK_Q, block_k)
                               for q0 in range(0, n, BLOCK_Q))


def test_bhsd_geometry():
    g = bhsd_geometry((4, 10, 4096, 64), GROUP_ROWS)
    # 40 planes of 4096 rows of 128 bytes; no head dimension inside a plane
    assert g == TmaGeometry((64, 1, 4096, 40), (128, 128, 4096 * 128),
                            (PANEL_COLS, 1, GROUP_ROWS, 1))
    assert bhsd_geometry((20, 1000, 128), BLOCK_K) == TmaGeometry(
        (128, 1, 1000, 20), (256, 256, 1000 * 256), (PANEL_COLS, 1, BLOCK_K, 1))
    with pytest.raises(ValueError):
        bhsd_geometry((1, 1, 1024, 32), GROUP_ROWS)


def test_packed_geometry_takes_strides_and_column_slices():
    x = torch.empty((4, 1024, 1280), dtype=torch.bfloat16)
    g = packed_geometry(x.shape, x.stride(), 20, BLOCK_K)
    # head h of row r of batch b: b * 1024 * 2560 + r * 2560 + h * 128 bytes
    assert g == TmaGeometry((64, 20, 1024, 4), (128, 2560, 1024 * 2560),
                            (PANEL_COLS, 1, BLOCK_K, 1))
    fused = torch.empty((2, 77, 3 * 256), dtype=torch.bfloat16)
    part = fused[..., 256:512]
    g = packed_geometry(part.shape, part.stride(), 2, GROUP_ROWS)
    assert g.dims == (128, 2, 77, 2)
    assert g.strides == (256, 3 * 512, 77 * 3 * 512)
    # a batch of one: its stride never enters an address
    one = packed_geometry((1, 50, 128), (12345, 128, 1), 2, GROUP_ROWS)
    assert one.strides == (128, 256, 50 * 256)
    with pytest.raises(ValueError):         # column stride 2
        packed_geometry((1, 64, 128), (64 * 256, 256, 2), 2, GROUP_ROWS)
    with pytest.raises(ValueError):         # rows do not start on 16 bytes
        packed_geometry((1, 64, 128), (64 * 132, 132, 1), 2, GROUP_ROWS)
    with pytest.raises(ValueError):         # heads do not divide the row
        packed_geometry((1, 64, 128), (64 * 128, 128, 1), 3, GROUP_ROWS)
    with pytest.raises(ValueError):         # a broadcast batch
        packed_geometry((2, 64, 128), (0, 128, 1), 2, GROUP_ROWS)


def test_geometry_argument_layout():
    """Four records of 4 dims, 3 byte strides and 4 box extents, uint64, in
    the order the C entry points read them."""
    gq = bhsd_geometry((2, 3, 1000, 64), GROUP_ROWS)
    gk = bhsd_geometry((2, 3, 1100, 64), BLOCK_K)
    arg = _geometry_argument((gq, gk, gk, gq))
    assert list(arg) == [64, 1, 1000, 6, 128, 128, 128000, 64, 1, 64, 1,
                         64, 1, 1100, 6, 128, 128, 140800, 64, 1, 128, 1] \
        + [64, 1, 1100, 6, 128, 128, 140800, 64, 1, 128, 1,
           64, 1, 1000, 6, 128, 128, 128000, 64, 1, 64, 1]
