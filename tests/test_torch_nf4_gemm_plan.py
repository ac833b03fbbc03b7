"""The NF4 prefill route's launch plan (`ops/nf4_matmul.plan_nf4_gemm`) and
its plain walk (`nf4_gemm_tiled`): coverage and limits of the plan at the
13B LLaMA's shapes and at odd ones, the walk against the plain version and
against the Pallas kernel in interpret mode. Inputs come from numpy; fp32
for the walks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.nf4_matmul import nf4_matmul_fused
from faithdiff_tpu.utils import quantize as jq
from faithdiff_tpu_torch.ops import nf4_matmul as N
from faithdiff_tpu_torch.utils import quantize as tq

LLAMA_13B = [(5120, 5120), (5120, 13824), (13824, 5120)]
# in = 64: the tiny LLaMA (half a K step); in = 576: the low-nibble half
# starts mid-block and the last K step is half full; out = 40 and 288:
# ragged weight tiles
ODD = [(64, 128), (192, 40), (512, 288), (576, 40)]
# a decode step of 9 and 16 images, the caption's prefill of one and two
# images (2 x 622 tokens), the two-layer prefill's 1024 tokens
MS = [9, 16, 640, 1024, 1244]


@pytest.mark.parametrize("in_f,out_f", LLAMA_13B + ODD)
def test_plan_covers_every_row_packed_byte_and_x_row_once(in_f, out_f):
    half = in_f // 2
    for m in MS:
        plan = N.plan_nf4_gemm(m, in_f, out_f)
        tiles = plan.tiles()
        assert len(tiles) == len(set(tiles)) == plan.grid == plan.w_tiles * plan.m_tiles
        rows = np.zeros(out_f + N.GEMM_ROWS, np.int32)
        x_rows = np.zeros(m + plan.n_tile, np.int32)
        for r0 in {r for r, _ in tiles}:
            rows[r0:r0 + N.GEMM_ROWS] += 1
        for m0 in {c for _, c in tiles}:
            x_rows[m0:m0 + plan.n_tile] += 1
        # every weight row and every row of x in exactly one tile; no tile
        # wholly past the edge
        assert np.all(rows[:out_f] == 1) and np.all(x_rows[:m] == 1), (m, plan)
        assert max(r for r, _ in tiles) < out_f and max(c for _, c in tiles) < m
        # every tile pairs each weight tile with each x tile once: the steps
        # of a block take each packed byte of its rows once (high nibble:
        # column c, low nibble: column in/2 + c)
        packed = np.zeros(half, np.int32)
        cols = []
        for s in range(plan.steps):
            c = plan.step_columns(s)
            hi = [k for k in c if k < half]
            assert [k - half for k in c if k >= half] == hi
            packed[hi] += 1
            cols += c
        assert np.all(packed == 1)
        assert sorted(cols) == list(range(in_f))


@pytest.mark.parametrize("in_f,out_f", LLAMA_13B + ODD)
def test_plan_stays_within_its_limits(in_f, out_f):
    for m in MS + [17, 100, 4096]:
        plan = N.plan_nf4_gemm(m, in_f, out_f)
        assert (plan.m, plan.rows, plan.threads) == (m, 128, 384)
        assert plan.n_tile in N.GEMM_N_TILES and sum(plan.n_parts) == plan.n_tile
        assert all(p in (16, 32, 64, 128) for p in plan.n_parts)
        assert list(plan.n_parts) == sorted(plan.n_parts, reverse=True)
        assert 2 <= plan.stages <= N.GEMM_MAX_STAGES
        assert plan.stage_bytes == 2 * plan.n_tile * 128 + 128 * 64 + 128 * 16
        assert plan.smem_bytes == 1024 + plan.stages * (plan.stage_bytes + 16)
        assert plan.smem_bytes <= N.GEMM_SMEM_LIMIT < 227 * 1024
        # no deeper ring would fit, short of the cap
        assert (plan.stages == N.GEMM_MAX_STAGES
                or 1024 + (plan.stages + 1) * (plan.stage_bytes + 16) > N.GEMM_SMEM_LIMIT)
        # the epilogue's transpose fits over the ring
        assert plan.epilogue_bytes == plan.n_tile * 272 <= plan.stages * plan.stage_bytes
        assert plan.steps == -(-in_f // 128)
        assert plan.waves == plan.grid / 132
        assert plan.full == (out_f % 128 == 0 and m % plan.n_tile == 0)
        if m <= 16:
            # a decode batch of 9-16 images: one narrow x tile, not 64 rows
            assert plan.n_tile == 16


def test_plan_picks_tiles_by_waves_and_rejects_what_it_does_not_take():
    # the caption's prefill: 208 rows of x a tile, 6 x tiles of 1244 rows,
    # 240 blocks on 132 SMs at out = 5120 (1.82 waves; 256 rows would give
    # 200 blocks, 2 waves of wider tiles), 648 at out = 13824
    got = [(p.n_tile, p.n_parts, p.grid, p.stages)
           for p in (N.plan_nf4_gemm(1244, i, o) for i, o in LLAMA_13B)]
    assert got == [(208, (128, 64, 16), 240, 3), (208, (128, 64, 16), 648, 3),
                   (208, (128, 64, 16), 240, 3)]
    assert [N.plan_nf4_gemm(640, i, o).grid for i, o in LLAMA_13B] == [120, 324, 120]
    assert N.plan_nf4_gemm(1024, 5120, 5120).n_tile == 176
    p = N.plan_nf4_gemm(16, 5120, 5120)
    assert (p.n_tile, p.grid, p.stages, p.full) == (16, 40, 4, True)
    p = N.plan_nf4_gemm(9, 64, 40)
    assert (p.steps, p.grid, p.full) == (1, 1, False)
    assert N.plan_nf4_gemm(9, 64, 40) is p               # cached
    for bad in ((8, 512, 64), (1, 512, 64), (20, 96, 64), (20, 0, 64), (20, 512, 0)):
        with pytest.raises(ValueError):
            N.plan_nf4_gemm(*bad)
    # the plan is the one for its tile; a tile the kernel has no instance
    # for is refused
    for i, o in LLAMA_13B:
        p = N.plan_nf4_gemm(640, i, o)
        assert N.gemm_plan_for_tile(640, i, o, p.n_tile) == p
    assert N.gemm_plan_for_tile(640, 5120, 5120, 256).stages == 3
    for n_tile in (0, 8, 24, 272):
        with pytest.raises(ValueError):
            N.gemm_plan_for_tile(640, 5120, 5120, n_tile)


def _case(m, in_f, out_f, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((in_f, out_f)) * in_f ** -0.5).astype(np.float32)
    w[:64, 0] = 0.0                                    # an all-zero block
    x = rng.standard_normal((m, in_f)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("in_f,out_f", ODD)
@pytest.mark.parametrize("m", [9, 16, 17, 300])
def test_tile_walk_matches_plain_version(m, in_f, out_f):
    w, x = _case(m, in_f, out_f, 7 * m + in_f)
    q = tq.quantize_nf4(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    got = N.nf4_gemm_tiled(xt, q, N.plan_nf4_gemm(m, in_f, out_f))
    # the same decoded weights; fp32 sums in the walk's order
    np.testing.assert_allclose(got.numpy(), N.nf4_matmul_reference(xt, q).numpy(),
                               rtol=1e-5, atol=1e-5)


# the Pallas kernel takes in % 256 == 0 and out % 32 == 0
@pytest.mark.parametrize("m,in_f,out_f", [(20, 768, 96), (33, 256, 160)])
def test_tile_walk_matches_pallas_interpret(m, in_f, out_f):
    w, x = _case(m, in_f, out_f, 11)
    q = tq.quantize_nf4(torch.from_numpy(w))
    got = N.nf4_gemm_tiled(torch.from_numpy(x), q, N.plan_nf4_gemm(m, in_f, out_f))
    want = nf4_matmul_fused(jnp.asarray(x), jq.quantize_nf4(jnp.asarray(w)),
                            compute_dtype=jnp.float32, interpret=True)
    # fp32 sums of the same fp32 products in two orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tile_walk_keeps_bf16_decode_and_lead_dims():
    w, x = _case(18, 576, 40, 3)
    q = tq.quantize_nf4(torch.from_numpy(w))
    xb = torch.from_numpy(x).bfloat16().reshape(2, 9, 576)
    got = N.nf4_gemm_tiled(xb, q, N.plan_nf4_gemm(18, 576, 40))
    ref = N.nf4_matmul_reference(xb, q)
    assert got.shape == (2, 9, 40) and got.dtype == torch.bfloat16
    # one bf16 rounding of fp32 sums taken in two orders
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 1e-2 * (1 + ref.float().abs())).all())
    with pytest.raises(ValueError):
        N.nf4_gemm_tiled(xb, q, N.plan_nf4_gemm(19, 576, 40))
