"""The wide bf16 flash kernel's host side on the CPU: its split plan
(`wide_plan`), the tensor-map geometry the wrapper hands it
(`wide_geometry`), the plain version of its split partials and of their
merge (`wide_partials`, `merge_wide_partials`) against the plain attention
and JAX's Pallas kernel in interpret mode, and the whole launch path with
the two C entry points replaced by a stand-in that reads its arguments as
the kernels do (tensor maps, partial buffers, output strides).

The kernels themselves run only on a card (`tests/test_torch_cuda.py`,
`chip_smoke.py`'s `attention_wide` lines). Inputs come from numpy."""
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.attention import _flash_attention_fwd_impl
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops import attention as A

WIDE_DIMS = (192, 256, 320, 384, 448, 512)
# (batch, heads, q_len, kv_len, causal): the timed shapes, the VAE's at a
# batch of tiles, ragged, causal and short ones
PLAN_SHAPES = [(1, 1, 1024, 1024, False), (2, 4, 2048, 2048, False),
               (1, 1, 16384, 16384, False), (4, 1, 1024, 1024, False),
               (2, 2, 1000, 1100, False), (1, 2, 1030, 1030, True),
               (1, 1, 40, 77, False), (3, 5, 4096, 64, False)]

WIDE_SOURCE = os.path.join(os.path.dirname(A.__file__), "..", "csrc",
                           "flash_attention_wide.cu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain walks are many small products: one thread each keeps them
    from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_plan_fits_shared_memory_and_fills_one_wave(d, shape):
    b, h, q_len, kv_len, causal = shape
    plan = A.wide_plan(b, h, q_len, kv_len, d, causal)
    assert plan == A.wide_plan(b, h, q_len, kv_len, d, causal)
    # the shared memory of a block is the source's layout, which holds itself
    # to the card's 232,448 bytes at compile time
    with open(WIDE_SOURCE) as f:
        source = f.read()
    assert "constexpr int kSmemLimit = 232448;" in source
    assert "static_assert(kVStages >= 1 && kSmemBytes <= kSmemLimit" in source
    assert plan.block_q == (128 if d <= 256 else 64)
    assert plan.q_blocks * plan.block_q >= q_len > (plan.q_blocks - 1) * plan.block_q
    assert plan.kv_tiles == -(-kv_len // 64)
    # every split holds at least one tile, and together they hold them all
    assert (plan.splits - 1) * plan.tiles_per_split < plan.kv_tiles
    assert plan.splits * plan.tiles_per_split >= plan.kv_tiles
    items = plan.q_blocks * b * h
    assert plan.blocks == items * plan.splits
    if plan.splits > 1:
        # one wave of one block an SM, each split at least MIN_SPLIT_TILES deep
        assert plan.blocks <= A.H100_SMS
        assert plan.tiles_per_split >= A.MIN_SPLIT_TILES
    # a card at most half full splits wherever two splits would be deep enough
    assert plan.splits > 1 or 2 * items > A.H100_SMS \
        or plan.kv_tiles < 2 * A.MIN_SPLIT_TILES


def test_plan_at_the_vae_shape():
    """[1, 1, 1024, 512] (the restore's VAE attention), as PERF.md names it:
    16 q blocks of 64 rows, 8 splits of 2 tiles, 128 blocks; 2 splits of 8
    at a batch of 4 tiles."""
    assert A.wide_plan(1, 1, 1024, 1024, 512) == A.WidePlan(
        block_q=64, q_blocks=16, kv_tiles=16, splits=8, tiles_per_split=2,
        blocks=128)
    assert A.wide_plan(4, 1, 1024, 1024, 512).splits == 2
    assert A.wide_plan(1, 1, 1024, 1024, 256).splits == 8


@pytest.mark.parametrize("forced,want", [(1, 1), (2, 2), (3, 3), (5, 4), (16, 16),
                                         (40, 16)])
def test_forced_splits_are_rounded_to_equal_tile_counts(forced, want):
    plan = A.wide_plan(1, 1, 1024, 1024, 512, splits=forced)
    assert plan.splits == want
    assert plan.tiles_per_split == -(-16 // want)


def _qkv(rng, b, h, q_len, kv_len, d, dtype=torch.float32):
    return tuple(torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                 .to(dtype) for n in (q_len, kv_len, kv_len))


@pytest.mark.parametrize("d,shape,causal,splits", [
    (192, (1, 2, 256, 256), False, None), (512, (1, 1, 300, 300), True, 3),
    (320, (2, 1, 200, 333), False, 4), (512, (1, 1, 512, 512), False, None),
    (256, (1, 2, 260, 260), True, None)])
def test_plain_merge_matches_plain_attention(d, shape, causal, splits):
    """In fp32 the split partials merged agree with the same walk in one
    split within 1e-6 * max|ref| (what the merge adds), and with
    `attention_reference` within 4e-6 * max|ref|: fp32's own floor, as
    `attention_reference` itself lies up to 2.0e-6 * max|ref| from the
    float64 result on these shapes (base 2 against base e adds no more)."""
    rng = np.random.default_rng(d + shape[2])
    q, k, v = _qkv(rng, *shape, d)
    b, h, q_len, kv_len = shape
    plan = A.wide_plan(b, h, q_len, kv_len, d, causal, splits=splits or 4)
    assert plan.splits > 1
    out = A.wide_attention_split(q, k, v, d ** -0.5, causal, plan)
    one = A.wide_attention_split(q, k, v, d ** -0.5, causal,
                                 A.wide_plan(b, h, q_len, kv_len, d, causal, splits=1))
    ref = A.attention_reference(q, k, v, d ** -0.5, causal)
    top = float(ref.abs().max())
    assert float((out - one).abs().max()) <= 1e-6 * top
    assert float((out - ref).abs().max()) <= 4e-6 * top


@pytest.mark.parametrize("d", [256, 512])
def test_plain_merge_matches_pallas_interpret(d):
    """The kernel's planned split at [1, 1, 1024, d] in bf16 (p rounded to
    bf16 before p.v) against JAX's `_flash_kernel` in interpret mode,
    within the card's bf16 tolerance (1e-2 + 8e-3 |ref|)."""
    rng = np.random.default_rng(50 + d)
    q, k, v = (rng.standard_normal((1, 1, 1024, d)).astype(np.float32) for _ in range(3))
    plan = A.wide_plan(1, 1, 1024, 1024, d)
    assert plan.splits > 1
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = A.wide_attention_split(tq, tk, tv, d ** -0.5, False, plan).float().numpy()
    want = np.asarray(_flash_attention_fwd_impl(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=d ** -0.5,
        causal=False, block_q=512, block_k=512, interpret=True)).astype(np.float32)
    assert np.all(np.abs(ours - want) <= 1e-2 + 8e-3 * np.abs(want))


def _strides(tensors, packed_heads=None):
    """The 12 element strides the strided launch passes: (batch, head, row)
    of each operand, as the wrapper builds them."""
    if packed_heads is None:
        return tuple(x for t in tensors for x in t.stride()[:3])
    d = tensors[0].shape[2] // packed_heads
    return tuple(x for t in tensors for x in (t.stride(0), d, t.stride(1)))


def _through_geometry(t, g):
    """t's storage read as the tensor map `g` addresses it: [batch, head,
    row, column] from the byte strides, starting at t's first element."""
    d, heads, rows, batches = g.dims
    sh, sr, sb = (s // 2 for s in g.strides)
    return torch.as_strided(t, (batches, heads, rows, d), (sb, sh, sr, 1),
                            t.storage_offset())


@pytest.mark.parametrize("d", [192, 512])
@pytest.mark.parametrize("layout", ["bhsd", "packed", "packed_slices"])
def test_wide_geometry_addresses_every_operand(d, layout):
    """The maps the wrapper encodes reach each element of q, k, v and o
    where the tensors hold it: BHSD planes (heads folded into the batch
    dim), packed rows, and column slices of fused projections."""
    g = torch.Generator().manual_seed(d)
    if layout == "bhsd":
        b, h = 2, 3
        q, k, v, o = (torch.randn((b, h, n, d), generator=g).bfloat16()
                      for n in (130, 70, 70, 130))
        strides = _strides((q, k, v, o))
        views = [t.reshape(b * h, t.shape[2], d) for t in (q, k, v, o)]
    else:
        b, h = 2, 2
        f = h * d
        if layout == "packed":
            q, k, v, o = (torch.randn((b, n, f), generator=g).bfloat16()
                          for n in (130, 70, 70, 130))
        else:
            q = torch.randn((b, 130, 3 * f), generator=g).bfloat16()[..., f:2 * f]
            k, v = torch.randn((b, 70, 2 * f), generator=g).bfloat16().split(f, dim=-1)
            o = torch.randn((b, 130, f), generator=g).bfloat16()
        strides = _strides((q, k, v, o), packed_heads=h)
        views = [t.unflatten(-1, (h, d)).transpose(1, 2).reshape(b * h, t.shape[1], d)
                 for t in (q, k, v, o)]
    geometry = A.wide_geometry(strides, (b, h, 130, 70, d))
    for t, view, geo, rows in zip((q, k, v, o), views, geometry, (130, 70, 70, 130)):
        assert geo.box == (64, 1, 64, 1)
        assert all(s % 16 == 0 for s in geo.strides)
        seen = _through_geometry(t, geo)
        assert seen.shape[2] == rows
        assert torch.equal(seen.reshape(b * h, rows, d), view)


def _from_address(ptr, shape, strides, dtype):
    """A tensor over memory at `ptr` (CPU), element strides `strides`."""
    span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    size = torch.tensor([], dtype=dtype).element_size()
    buf = (ctypes.c_char * (span * size)).from_address(ptr)
    flat = torch.frombuffer(buf, dtype=dtype)
    return torch.as_strided(flat, shape, strides)


def _kernel_stand_in(fn_name, args):
    """What the two C entry points do, read through their arguments: the
    tensor maps of q, k, v, o (flat uint64 records), the split count and
    tiles a split, the partial buffers and their rows a plane, the merge's
    output strides."""
    if fn_name == "fd_flash_attention_wide_fwd":
        q_ptr, k_ptr, v_ptr, o_ptr, geometry, po, pml, rows_pad, d, splits, per, \
            scale_log2, causal = args
        flat = list(geometry)
        ops = []
        for i, ptr in enumerate((q_ptr, k_ptr, v_ptr, o_ptr)):
            dims, strides, box = flat[11 * i:11 * i + 4], flat[11 * i + 4:11 * i + 7], \
                flat[11 * i + 7:11 * i + 11]
            assert dims[0] == d and box == [64, 1, 64, 1]
            sh, sr, sb = (s // 2 for s in strides)
            ops.append(_from_address(ptr, (dims[3], dims[1], dims[2], d),
                                     (sb, sh, sr, 1), torch.bfloat16))
        q, k, v, o = ops
        bq, hq, q_len, _ = q.shape
        kv_len = k.shape[2]
        block_q = 128 if d <= 256 else 64
        q_blocks = -(-q_len // block_q)
        assert rows_pad == q_blocks * block_q      # as the entry point refuses
        tiles = -(-kv_len // 64)
        plan = A.WidePlan(block_q, q_blocks, tiles, splits, per, 0)
        part_o, part_ml = A.wide_partials(q, k, v, scale_log2 / A.LOG2E, bool(causal), plan)
        if splits == 1:
            rows = (part_o[0] / part_ml[0, ..., 1:]).reshape(bq, hq, -1, d)
            o.copy_(rows[:, :, :q_len].to(torch.bfloat16))
        else:
            _from_address(po, part_o.shape, part_o.stride(), torch.float32).copy_(part_o)
            _from_address(pml, part_ml.shape, part_ml.stride(), torch.float32).copy_(part_ml)
        return
    assert fn_name == "fd_flash_attention_wide_merge"
    po, pml, o_ptr, o_strides, heads, planes, q_len, rows_pad, d, splits = args
    part_o = _from_address(po, (splits, planes, rows_pad, d),
                           (planes * rows_pad * d, rows_pad * d, d, 1), torch.float32)
    part_ml = _from_address(pml, (splits, planes, rows_pad, 2),
                            (planes * rows_pad * 2, rows_pad * 2, 2, 1), torch.float32)
    sb, sh, sr = list(o_strides)
    o = _from_address(o_ptr, (planes // heads, heads, q_len, d), (sb, sh, sr, 1),
                      torch.bfloat16)
    merged = A.merge_wide_partials(part_o, part_ml)[:, :q_len]
    o.copy_(merged.reshape(o.shape).to(torch.bfloat16))


@pytest.fixture
def stand_in_kernels(monkeypatch):
    calls = []

    def launch(lib, fn_name, argtypes, args, device):
        assert len(argtypes) == len(args) + 1          # and the stream
        calls.append(fn_name)
        _kernel_stand_in(fn_name, args)

    monkeypatch.setattr(A, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(A, "_sm_count", lambda device: A.H100_SMS)
    monkeypatch.setattr(A, "_launch", launch)
    monkeypatch.setattr(_build, "load", lambda name: None)
    _build.launches.clear()
    return calls


@pytest.mark.parametrize("layout,d,q_len,kv_len,causal", [
    ("bhsd", 512, 256, 256, False), ("bhsd", 192, 200, 333, False),
    ("bhsd", 384, 260, 260, True), ("packed", 512, 256, 256, False),
    ("packed", 192, 200, 333, False), ("packed", 448, 130, 100, False)])
def test_launch_path_through_the_kernel_arguments(stand_in_kernels, layout, d,
                                                  q_len, kv_len, causal):
    """The wrapper's launch with the C entry points replaced by a stand-in
    that computes the split partials and the merge from what it is handed
    (tensor maps, partial buffers, strides): the plain attention, within
    the bf16 tolerance, and the merge launched (and counted) exactly when
    the plan splits."""
    rng = np.random.default_rng(d + q_len)
    b, h = 1, 2
    q, k, v = _qkv(rng, b, h, q_len, kv_len, d, torch.bfloat16)
    plan = A.wide_plan(b, h, q_len, kv_len, d, causal)
    if layout == "bhsd":
        out = A._flash_attention_launch(q, k, v, d ** -0.5, causal)
        ref = A.attention_reference(q, k, v, d ** -0.5, causal)
        counter = "flash_attention_wide_fwd"
    else:
        packed = [t.transpose(1, 2).reshape(b, t.shape[2], h * d) for t in (q, k, v)]
        fused = torch.cat([packed[0], packed[0]], dim=-1)[..., h * d:]   # a column slice
        out = A._flash_packed_launch(fused, packed[1], packed[2], h, d ** -0.5)
        ref = A.einsum_bsnd(packed[0], packed[1], packed[2], h, d ** -0.5)
        counter = "flash_attention_wide_bsnd_fwd"
    merges = int(plan.splits > 1)
    assert stand_in_kernels == ["fd_flash_attention_wide_fwd"] + \
        ["fd_flash_attention_wide_merge"] * merges
    assert dict(_build.launches) == {counter: 1, **(
        {"flash_attention_wide_merge": 1} if merges else {})}
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())
