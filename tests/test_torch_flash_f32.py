"""The fp32 flash-attention wiring (`ops/attention.py` -> the fp32 kernel of
`csrc/flash_attention_f32.cu`) on the CPU, against the JAX package's
Pallas kernels in interpret mode at fp32.

The kernel itself runs only on a card (`tests/test_torch_cuda.py`). Here
its two C entry points are replaced by a stand-in that reads its
arguments as the kernels do: the tensor maps of q, k, v and o (dims, byte
strides, boxes), the split plan, the partial buffers and the merge's
output strides, and computes the kernel's plain walk (`f32_partials`,
`merge_wide_partials`) from them. A wrong geometry, stride, plan or
buffer shows as a wrong result. Inputs come from numpy and go to both
sides."""
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.attention import _flash_attention_fwd_impl
from faithdiff_tpu.ops.attention import attention_packed as jax_attention_packed
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops import attention as A


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The stand-in's plain walks are many small products: one thread each
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _from_address(ptr, shape, strides):
    """An fp32 tensor over memory at `ptr` (CPU), element strides `strides`."""
    span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    buf = (ctypes.c_char * (span * 4)).from_address(ptr)
    return torch.as_strided(torch.frombuffer(buf, dtype=torch.float32), shape, strides)


def _kernel_stand_in(fn_name, args):
    """What fd_flash_attention_f32_fwd and fd_flash_attention_f32_merge do,
    read through their arguments."""
    if fn_name == "fd_flash_attention_f32_fwd":
        *ptrs, geometry, po, pml, rows_pad, d, splits, per, scale_log2, causal = args
        flat = list(geometry)
        ops = []
        for i, ptr in enumerate(ptrs):
            dims, strides, box = (flat[11 * i:11 * i + 4], flat[11 * i + 4:11 * i + 7],
                                  flat[11 * i + 7:11 * i + 11])
            assert dims[0] == d and box == [32, 1, 64, 1]
            assert all(st % 16 == 0 for st in strides)      # as TMA demands
            sh, sr, sb = (st // 4 for st in strides)
            ops.append(_from_address(ptr, (dims[3], dims[1], dims[2], d), (sb, sh, sr, 1)))
        q, k, v, o = ops
        q_len, kv_len = q.shape[2], k.shape[2]
        q_blocks = -(-q_len // 64)
        assert rows_pad == q_blocks * 64                 # as the entry point refuses
        tiles = -(-kv_len // 64)
        assert (splits - 1) * per < tiles <= splits * per
        plan = A.WidePlan(64, q_blocks, tiles, splits, per, 0)
        part_o, part_ml = A.f32_partials(q, k, v, scale_log2 / A.LOG2E, bool(causal), plan)
        if splits == 1:
            rows = (part_o[0] * (1.0 / part_ml[0, ..., 1:])).reshape(*q.shape[:2], -1, d)
            o.copy_(rows[:, :, :q_len])
        else:
            _from_address(po, part_o.shape, part_o.stride()).copy_(part_o)
            _from_address(pml, part_ml.shape, part_ml.stride()).copy_(part_ml)
        return
    assert fn_name == "fd_flash_attention_f32_merge"
    po, pml, o_ptr, o_strides, heads, planes, q_len, rows_pad, d, splits = args
    part_o = _from_address(po, (splits, planes, rows_pad, d),
                           (planes * rows_pad * d, rows_pad * d, d, 1))
    part_ml = _from_address(pml, (splits, planes, rows_pad, 2),
                            (planes * rows_pad * 2, rows_pad * 2, 2, 1))
    sb, sh, sr = list(o_strides)
    o = _from_address(o_ptr, (planes // heads, heads, q_len, d), (sb, sh, sr, 1))
    o.copy_(A.merge_wide_partials(part_o, part_ml)[:, :q_len].reshape(o.shape))


class _Seen(list):
    """The operand dtypes the device check saw; `calls`: the C entry points
    called, in order."""
    calls: list


@pytest.fixture
def card_free_launch(monkeypatch):
    """The launch path with the device check and the two C entry points
    replaced by the stand-in."""
    checked = _Seen()
    calls = checked.calls = []

    def launch(lib, fn_name, argtypes, args, device):
        assert len(argtypes) == len(args) + 1          # and the stream
        calls.append(fn_name)
        _kernel_stand_in(fn_name, args)

    monkeypatch.setattr(A, "_check_kernel_inputs",
                        lambda what, q, ts: checked.append([t.dtype for _, t in ts]))
    monkeypatch.setattr(A, "_sm_count", lambda device: A.H100_SMS)
    monkeypatch.setattr(A, "_launch", launch)
    monkeypatch.setattr(_build, "load", lambda name: None)
    _build.launches.clear()
    return checked


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,causal", [((2, 3, 256, 256), False),
                                          ((1, 2, 256, 256), True)])
def test_f32_launch_matches_pallas_interpret(card_free_launch, d, shape, causal):
    b, h, s, _ = shape
    q, k, v = _arrays([(b, h, s, d)] * 3, 20)
    scale = d ** -0.5
    ours = A.flash_attention_function(*(torch.from_numpy(a) for a in (q, k, v)),
                                      scale, causal)
    assert card_free_launch == [[torch.float32] * 3]
    assert _build.launches["flash_attention_f32_fwd"] == 1
    assert _build.launches["flash_attention_fwd"] == 0
    want = _flash_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v)), scale=scale, causal=causal,
        block_q=128, block_k=128, interpret=True)
    assert ours.dtype == torch.float32
    # fp32 on both sides; the Pallas kernel's base-2 online softmax differs
    # from one softmax by rounding only
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("heads,d", [(3, 64), (2, 128)])
def test_packed_f32_launch_matches_pallas_bsnd_interpret(card_free_launch, heads, d):
    """q a column slice of a fused [b, s, 3f] projection (row stride 3f),
    k and v contiguous: the head stride is d columns into a row."""
    f = heads * d
    qkv, k, v = _arrays([(2, 256, 3 * f), (2, 512, f), (2, 512, f)], 21)
    q = qkv[..., f:2 * f]
    tq = torch.from_numpy(qkv)[..., f:2 * f]
    ours = A.flash_attention_packed_function(tq, torch.from_numpy(k),
                                             torch.from_numpy(v), heads, d ** -0.5)
    assert _build.launches["flash_attention_f32_bsnd_fwd"] == 1
    assert ours.shape == (2, 256, f) and ours.is_contiguous()
    want = jax_attention_packed(*(jnp.asarray(np.ascontiguousarray(a))
                                  for a in (q, k, v)),
                                heads, use_flash=True, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=2e-5)


def test_f32_launch_gradient_is_the_plain_versions(card_free_launch):
    """Under autograd the fp32 forward keeps the plain version's backward,
    as the bf16 kernel does: the gradients equal autograd over
    `attention_reference` on the same inputs, bit for bit."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays([(1, 2, 128, 64)] * 3, 22))
    grad = torch.from_numpy(_arrays([(1, 2, 128, 64)], 23)[0])
    out = A.flash_attention_function(q, k, v, 0.125, True)
    got = torch.autograd.grad(out, (q, k, v), grad)
    want = torch.autograd.grad(A.attention_reference(q, k, v, 0.125, True),
                               (q, k, v), grad)
    assert _build.launches["flash_attention_f32_fwd"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("splits", [1, 2, None], ids=["1split", "2splits", "planned"])
@pytest.mark.parametrize("layout,d,q_len,kv_len,causal", [
    ("bhsd", 64, 200, 333, False), ("bhsd", 512, 130, 130, True),
    ("packed", 128, 130, 100, False), ("packed", 320, 70, 200, False)])
def test_split_launch_path_through_the_kernel_arguments(card_free_launch, monkeypatch,
                                                        splits, layout, d, q_len,
                                                        kv_len, causal):
    """One split, two and the plan's count (forced through `f32_plan`):
    within 2e-5 * max|ref| of the plain version, packed q a column slice of
    a fused projection, and the merge launched and counted exactly when
    the K/V range is split."""
    monkeypatch.setattr(A, "f32_plan", functools.partial(A.f32_plan, splits=splits))
    b, h = 1, 2
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        [(b, h, q_len, d), (b, h, kv_len, d), (b, h, kv_len, d)], d + q_len))
    if layout == "bhsd":
        out = A._flash_attention_launch(q, k, v, d ** -0.5, causal)
        ref = A.attention_reference(q, k, v, d ** -0.5, causal)
        counter = A._strided_counter(torch.float32, d, False)
    else:
        packed = [t.transpose(1, 2).reshape(b, t.shape[2], h * d) for t in (q, k, v)]
        fused = torch.cat([packed[0], packed[0]], dim=-1)[..., h * d:]   # a column slice
        out = A._flash_packed_launch(fused, packed[1], packed[2], h, d ** -0.5)
        ref = A.einsum_bsnd(packed[0], packed[1], packed[2], h, d ** -0.5)
        counter = A._strided_counter(torch.float32, d, True)
    plan = A.f32_plan(b, h, q_len, kv_len, d, causal)
    assert splits is None or plan.splits == splits
    merged = int(plan.splits > 1)
    assert card_free_launch.calls == ["fd_flash_attention_f32_fwd"] + \
        ["fd_flash_attention_f32_merge"] * merged
    assert dict(_build.launches) == {counter: 1, **(
        {"flash_attention_f32_merge": 1} if merged else {})}
    assert float((out - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


def test_f32_launch_refuses_strides_off_16_bytes(card_free_launch):
    """The fp32 kernel's tensor maps need byte strides that are multiples of
    16: a row stride of 66 floats is refused, naming the strides, before
    anything launches."""
    base = torch.zeros(2 * 66 * 128)
    q = base.as_strided((1, 1, 128, 64), (66 * 128, 66 * 128, 66, 1))
    out = torch.empty((1, 1, 128, 64))
    strides = [x for t in (q, q, q, out) for x in t.stride()[:3]]
    with pytest.raises(ValueError, match=r"q strides \(8448, 8448, 66\) are not "
                                         r"multiples of 4 elements"):
        A._strided_launch(q, q, q, out, strides, (1, 1, 128, 128, 64), 0.125, False)
    assert card_free_launch.calls == []
