"""The fp32 flash kernel's arithmetic and schedule on the CPU: TF32 rounding
as `cvt.rna.tf32.f32` does it, the 3xTF32 split of every product, the
kernel's blocks, tiles and K/V splits (`f32_plan`) and their merge, all as
the plain walk `flash_attention_f32_tiled` takes them, against JAX's
Pallas kernels in interpret mode at fp32; and single-TF32 products on the
same inputs, which miss (the reason for the split).

The kernel itself runs only on a card (`tests/test_torch_cuda.py`,
`chip_smoke.py`'s fp32 rows). Inputs come from numpy."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.attention import (_flash_attention_bsnd_impl,
                                         _flash_attention_fwd_impl)
from faithdiff_tpu_torch.ops import attention as A

DIMS = (64, 128, 192, 256, 320, 384, 448, 512)
# (batch, heads, q_len, kv_len, causal): the trainer's and the timed
# shapes, the VAE's at a batch of 2 and 4, ragged, causal and short ones
PLAN_SHAPES = [(2, 10, 4096, 4096, False), (2, 20, 1024, 1024, False),
               (1, 40, 1024, 1024, True), (1, 1, 1024, 1024, False),
               (2, 1, 1024, 1024, False), (4, 1, 1024, 1024, False),
               (2, 4, 2048, 2048, False), (2, 2, 1000, 1100, False),
               (1, 2, 1030, 1030, True), (1, 2, 40, 77, False), (3, 5, 4096, 64, False)]
F32_SOURCE = os.path.join(os.path.dirname(A.__file__), "..", "csrc",
                          "flash_attention_f32.cu")
TOL = 2e-5       # chip_smoke.F32_FLASH_TOL: the kernel against the fp32 plain version


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain walks are many small products: one thread each keeps them
    from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tf32_round_is_cvt_rna():
    """To nearest, ties away from zero, the 13 low mantissa bits clear;
    inf and NaN pass; the split's two parts sum back to x within 2^-22."""
    one = 1.0 + 2.0 ** -11                       # a tie between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, 3.0,
                      float("inf"), -float("inf")], dtype=torch.float32)
    got = A.tf32_round(x)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9, 1.0, 3.0,
            float("inf"), -float("inf")]
    assert got.tolist() == want
    assert torch.isnan(A.tf32_round(torch.tensor([float("nan")]))).all()
    r = np.random.default_rng(0)
    v = torch.from_numpy((r.standard_normal(4096) * 10.0 ** r.uniform(-6, 6, 4096))
                         .astype(np.float32))
    big, small = A.split_tf32(v)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((big - v).abs() / v.abs()).max()) <= 2.0 ** -11
    assert float(((big + small - v).abs() / v.abs()).max()) <= 2.0 ** -22


def _arrays(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _max_err(ours, want):
    return float(np.abs(ours - want).max())


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("q_len,kv_len,causal,splits", [
    (192, 300, False, None),            # ragged last tile, the planned split
    (128, 128, True, 2)])               # causal, two splits a q block
def test_walk_matches_pallas_interpret(d, q_len, kv_len, causal, splits):
    """3xTF32 within 2e-5 * max|ref| of the Pallas kernel at fp32, while
    single TF32 (big.big alone) on the same inputs is at least 10x further
    and outside that tolerance."""
    b, h = 1, 2
    q, k, v = _arrays(d + q_len, (b, h, q_len, d), (b, h, kv_len, d), (b, h, kv_len, d))
    scale = d ** -0.5
    plan = A.f32_plan(b, h, q_len, kv_len, d, causal, splits=splits)
    assert plan.splits > 1
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ours = A.flash_attention_f32_tiled(tq, tk, tv, scale, causal, plan=plan).numpy()
    single = A.flash_attention_f32_tiled(tq, tk, tv, scale, causal, plan=plan,
                                         products=1).numpy()
    want = np.asarray(_flash_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v)), scale=scale, causal=causal,
        block_q=128, block_k=128, interpret=True))
    tol = TOL * float(np.abs(want).max())
    err, err1 = _max_err(ours, want), _max_err(single, want)
    assert err <= tol
    assert err1 >= 10 * err and err1 > tol


@pytest.mark.parametrize("heads,d", [(2, 64), (2, 256)])
def test_walk_of_packed_rows_matches_pallas_bsnd_interpret(heads, d):
    """q a column slice of a fused [b, s, 3f] projection seen as [B, H, S,
    d] heads, k and v packed rows, against `_flash_attention_bsnd_impl`."""
    f = heads * d
    qkv, k, v = _arrays(60 + d, (1, 128, 3 * f), (1, 192, f), (1, 192, f))
    q = qkv[..., f:2 * f]

    def heads_of(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.unflatten(-1, (heads, d)).transpose(1, 2)

    ours = A.flash_attention_f32_tiled(heads_of(q), heads_of(k), heads_of(v), d ** -0.5)
    ours = ours.transpose(1, 2).reshape(1, 128, f).numpy()
    want = np.asarray(_flash_attention_bsnd_impl(
        *(jnp.asarray(np.ascontiguousarray(a)) for a in (q, k, v)), heads=heads,
        scale=d ** -0.5, interpret=True))
    assert _max_err(ours, want) <= TOL * float(np.abs(want).max())


def test_layout_fits_shared_memory():
    """The source refuses at compile time an instance whose shared memory
    exceeds its budget (a block's 232,448 bytes, or at d <= 128 half the
    SM's, two blocks an SM) or whose ring holds fewer than two panels a
    column half; `f32_blocks_per_sm`, which sizes `f32_plan`'s wave, is
    the source's kBlocksPerSm at every head dim."""
    with open(F32_SOURCE) as f:
        source = " ".join(f.read().split())
    for line in ("static constexpr int kBudget = kHalves == 1 ? 115712 : 232448;",
                 "static constexpr int kHalves = kHeadDim > 128 ? 2 : 1;",
                 "static constexpr int kBlocksPerSm = kHalves == 1 ? 2 : 1;",
                 "static_assert(kPanels % kHalves == 0 && kRing >= 2 * kHalves && "
                 "kSmemBytes <= kBudget,"):
        assert " ".join(line.split()) in source
    for d in DIMS:
        assert A.f32_blocks_per_sm(d) == (2 if d <= 128 else 1)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("d", DIMS)
def test_plan_fills_one_wave_with_equal_splits(d, shape):
    b, h, q_len, kv_len, causal = shape
    plan = A.f32_plan(b, h, q_len, kv_len, d, causal)
    assert plan == A.f32_plan(b, h, q_len, kv_len, d, causal)
    assert plan.block_q == 64
    assert plan.q_blocks * 64 >= q_len > (plan.q_blocks - 1) * 64
    assert plan.kv_tiles == -(-kv_len // 64)
    # every split holds at least one tile, and together they hold them all
    assert (plan.splits - 1) * plan.tiles_per_split < plan.kv_tiles
    assert plan.splits * plan.tiles_per_split >= plan.kv_tiles
    items = plan.q_blocks * b * h
    slots = A.H100_SMS * A.f32_blocks_per_sm(d)
    assert plan.blocks == items * plan.splits
    if plan.splits > 1:
        # one wave of the blocks the SMs hold, each split at least 2 tiles deep
        assert plan.blocks <= slots
        assert plan.tiles_per_split >= A.MIN_SPLIT_TILES
    # a card at most half full splits wherever two splits would be deep enough
    assert plan.splits > 1 or 2 * items > slots or plan.kv_tiles < 2 * A.MIN_SPLIT_TILES


def test_plan_at_the_paths_shapes():
    """What the fp32 paths launch: the 512 px trainer's attentions unsplit;
    the VAE's [1, 1, 1024, 512] in 8 splits of 2 tiles (128 blocks), the
    256 px trainer's [2, 1, 1024, 512] in 4 of 4 (128 blocks)."""
    for shape in ((2, 10, 4096, 4096, 64), (2, 20, 1024, 1024, 64),
                  (2, 4, 2048, 2048, 256)):
        assert A.f32_plan(*shape).splits == 1
    assert A.f32_plan(1, 40, 1024, 1024, 128, True).splits == 1
    assert A.f32_plan(1, 1, 1024, 1024, 512) == A.WidePlan(
        block_q=64, q_blocks=16, kv_tiles=16, splits=8, tiles_per_split=2, blocks=128)
    assert A.f32_plan(2, 1, 1024, 1024, 512) == A.WidePlan(
        block_q=64, q_blocks=16, kv_tiles=16, splits=4, tiles_per_split=4, blocks=128)
    assert A.f32_plan(1, 1, 1024, 1024, 256).splits == 8


@pytest.mark.parametrize("q_len,kv_len,causal,splits", [
    (300, 330, False, 3), (300, 300, True, 2), (100, 500, False, None)])
def test_walk_covers_every_row_and_tile_once(q_len, kv_len, causal, splits):
    """Under a plan every q block's live tiles are walked exactly once, by
    the split whose range holds them, and nothing else is walked."""
    plan = A.f32_plan(1, 1, q_len, kv_len, 64, causal, splits=splits)
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        q_len, (1, 1, q_len, 64), (1, 1, kv_len, 64), (1, 1, kv_len, 64)))
    visited = []
    A.flash_attention_f32_tiled(q, k, v, 0.125, causal, plan=plan, visited=visited)
    want = []
    for qb in range(plan.q_blocks):
        q0 = qb * 64
        for t in range(A.kv_tiles(q0, kv_len, causal, 64, 64)):
            want.append((q0, t // plan.tiles_per_split, 64 * t))
    assert sorted(visited) == sorted(want)
    assert len(set(visited)) == len(visited)


def test_walk_splits_agree_with_one_split():
    """The merge adds rounding only: 1, 2 and 8 splits of [1, 2, 512, 512] at
    d = 512 within 1e-6 * max|out| of each other."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(9, *[(1, 2, 512, 512)] * 3))
    outs = [A.flash_attention_f32_tiled(q, k, v, 512 ** -0.5,
                                        plan=A.f32_plan(1, 2, 512, 512, 512, splits=n))
            for n in (1, 2, 8)]
    top = float(outs[0].abs().max())
    for o in outs[1:]:
        assert float((o - outs[0]).abs().max()) <= 1e-6 * top
