"""The NF4 decode route's launch plan (`ops/nf4_matmul.plan_nf4_gemv`) and
its plain walk (`nf4_gemv_tiled`): coverage and limits of the plan at the
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
# in = 64: the tiny LLaMA (32 packed bytes a row, half a quad); in = 576:
# the low-nibble half starts mid-block and the last quad is half full;
# out = 40 and 288: ragged row blocks
ODD = [(64, 128), (192, 40), (512, 288), (576, 40)]
MS = list(range(1, 9))


def _coverage(plan):
    """How often the plan's (block, warp, quad, lane) walk reaches each
    (row, 16-byte packed vector), [out, in / 32]."""
    half = plan.in_f // 2
    n_vec = half // 16
    count = np.zeros((plan.out_f, n_vec), np.int32)
    for block in range(plan.grid):
        rows = np.arange(block * plan.rows, (block + 1) * plan.rows)
        rows = rows[rows < plan.out_f]
        for warp in range(plan.warps):
            for quad in plan.warp_quads(warp):
                vecs = 4 * quad + np.arange(4)
                vecs = vecs[vecs < n_vec]
                count[np.ix_(rows, vecs)] += 1
    return count


@pytest.mark.parametrize("in_f,out_f", LLAMA_13B + ODD)
def test_plan_covers_every_row_and_packed_byte_once(in_f, out_f):
    plan = N.plan_nf4_gemv(2, in_f, out_f)
    assert np.all(_coverage(plan) == 1)
    # the warps' K slices, in the mma's k order, are a permutation of the
    # columns: each column of x and of the weight once
    cols = torch.cat([N.gemv_k_order(plan, w) for w in range(plan.warps)])
    assert torch.equal(cols.sort().values, torch.arange(in_f))
    # no block without a row
    assert (plan.grid - 1) * plan.rows < out_f <= plan.grid * plan.rows


def _whole_fits(m, in_f):
    """Whether x staged whole, the scales and the rings fit shared memory."""
    return (N.gemv_scale_bytes(in_f) + m * (2 * in_f + 16) + N.gemv_ring_bytes(m, True)
            <= N.SMEM_LIMIT)


@pytest.mark.parametrize("in_f,out_f", LLAMA_13B + ODD)
def test_plan_stays_within_its_limits(in_f, out_f):
    for m in MS:
        plan = N.plan_nf4_gemv(m, in_f, out_f)
        x_whole = plan.x_whole
        assert plan.m == m
        assert plan.rows == 16 and plan.threads == 256
        # the warps take the quads in turn
        assert plan.quads_per_warp == -(-plan.quads // plan.warps)
        assert max(len(plan.warp_quads(w)) for w in range(plan.warps)) == \
            plan.quads_per_warp
        assert plan.smem_bytes == max(plan.scale_bytes + plan.x_bytes + plan.ring_bytes,
                                      plan.fold_bytes)
        assert plan.smem_bytes <= N.SMEM_LIMIT
        x_piece = 0 if x_whole else 4 * 4 * m
        assert plan.ring_bytes == 8 * N.STAGES * (2 * 32 + x_piece) * 16
        assert plan.x_bytes == (m * (2 * in_f + 16) if x_whole else 0)
        assert plan.scale_bytes >= 16 * ((in_f // 64) | 1) * 4
        assert plan.fold_bytes == 8 * 16 * 8 * 4
        assert plan.full == (out_f % 16 == 0 and in_f % 128 == 0)


@pytest.mark.parametrize("in_f,out_f", LLAMA_13B + ODD)
def test_plan_stages_x_whole_where_it_pays(in_f, out_f):
    for m in MS:
        plan = N.plan_nf4_gemv(m, in_f, out_f)
        small = 2 * m * in_f <= N.X_WHOLE_BYTES
        assert plan.x_whole == (_whole_fits(m, in_f) and (m >= N.X_WHOLE_MIN_M or small))
        if (in_f, out_f) in LLAMA_13B:
            # it fills the card: two waves of blocks on an H100's 132 SMs
            assert plan.grid / 132 >= 2, (m, plan)


def test_plan_splits_k_and_rejects_what_it_does_not_take():
    p = N.plan_nf4_gemv(2, 5120, 5120)
    assert (p.warps, p.quads, p.quads_per_warp, p.grid) == (8, 40, 5, 320)
    p = N.plan_nf4_gemv(8, 13824, 5120)
    assert (p.warps, p.quads_per_warp, p.quads) == (8, 14, 108)
    assert [len(p.warp_quads(w)) for w in range(8)] == [14] * 4 + [13] * 4
    assert list(p.warp_quads(3))[:3] == [3, 11, 19]
    # x of 8 x 13824 outgrows shared memory: it goes through the rings
    assert not _whole_fits(8, 13824) and not p.x_whole
    p = N.plan_nf4_gemv(1, 64, 128)
    assert (p.quads, p.grid, p.full) == (1, 8, False)
    assert [len(p.warp_quads(w)) for w in range(8)] == [1] + [0] * 7
    assert N.plan_nf4_gemv(2, 5120, 13824).full
    # the 13B shapes' choices (both x modes timed on an H100, PERF.md)
    picks = [N.plan_nf4_gemv(m, i, o).x_whole for m in (1, 2, 4, 8) for i, o in LLAMA_13B]
    assert picks == [True, True, True, True, True, False, True, True, True, True, True, False]
    # the card tests' ring cases: the plan itself picks the ring there
    assert not N.plan_nf4_gemv(2, 13824, 40).x_whole
    p = N.plan_nf4_gemv(2, 8256, 40)
    assert not p.x_whole and not p.full and (8256 // 2) % 64
    # the scales of a row of 135,168 columns and the rings outgrow shared
    # memory whichever way x goes
    for bad in ((0, 512, 64), (9, 512, 64), (2, 96, 64), (2, 512, 0), (8, 64 * 2112, 16)):
        with pytest.raises(ValueError):
            N.plan_nf4_gemv(*bad)


def _case(m, in_f, out_f, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((in_f, out_f)) * in_f ** -0.5).astype(np.float32)
    w[:64, 0] = 0.0                                    # an all-zero block
    x = rng.standard_normal((m, in_f)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("in_f,out_f", ODD)
@pytest.mark.parametrize("m", MS)
def test_tile_walk_matches_plain_version(m, in_f, out_f):
    w, x = _case(m, in_f, out_f, 7 * m + in_f)
    q = tq.quantize_nf4(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    plan = N.plan_nf4_gemv(m, in_f, out_f)
    got = N.nf4_gemv_tiled(xt, q, plan)
    # the same decoded weights; fp32 sums in the walk's order
    np.testing.assert_allclose(got.numpy(), N.nf4_matmul_reference(xt, q).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,in_f,out_f", [(3, 512, 288), (8, 256, 96)])
def test_tile_walk_matches_pallas_interpret(m, in_f, out_f):
    w, x = _case(m, in_f, out_f, 11)
    q = tq.quantize_nf4(torch.from_numpy(w))
    got = N.nf4_gemv_tiled(torch.from_numpy(x), q, N.plan_nf4_gemv(m, in_f, out_f))
    want = nf4_matmul_fused(jnp.asarray(x), jq.quantize_nf4(jnp.asarray(w)),
                            compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tile_walk_keeps_bf16_decode_and_lead_dims():
    w, x = _case(2, 576, 40, 3)
    q = tq.quantize_nf4(torch.from_numpy(w))
    xb = torch.from_numpy(x).bfloat16().reshape(1, 2, 576)
    got = N.nf4_gemv_tiled(xb, q, N.plan_nf4_gemv(2, 576, 40))
    ref = N.nf4_matmul_reference(xb, q)
    assert got.shape == (1, 2, 40) and got.dtype == torch.bfloat16
    # one bf16 rounding of fp32 sums taken in two orders
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 1e-2 * (1 + ref.float().abs())).all())
    with pytest.raises(ValueError):
        N.nf4_gemv_tiled(xb, q, N.plan_nf4_gemv(3, 576, 40))
