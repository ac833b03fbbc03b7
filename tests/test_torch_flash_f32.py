"""The fp32 flash-attention wiring (`ops/attention.py` -> the fp32 kernel of
`csrc/flash_attention_f32.cu`) on the CPU, against the JAX package's
Pallas kernels in interpret mode at fp32.

The kernel itself runs only on a card (`tests/test_torch_cuda.py`). Here
its entry point is replaced by `strided_attention`, which reads q, k, v
and writes the output through exactly the element strides and sizes the
wrapper hands the kernel: a wrong stride, layout or size shows as a wrong
result. Inputs come from numpy and go to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.attention import _flash_attention_fwd_impl
from faithdiff_tpu.ops.attention import attention_packed as jax_attention_packed
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops import attention as A


def strided_attention(q, k, v, out, strides, dims, scale, causal):
    """What the fp32 entry point computes, read through its arguments:
    per operand (batch, head, row) element strides, unit columns."""
    b, h, sq, skv, d = dims

    def view(t, i, rows):
        st = strides[3 * i:3 * i + 3]
        return torch.as_strided(t, (b, h, rows, d), (*st, 1), t.storage_offset())

    with torch.no_grad():
        view(out, 3, sq).copy_(A.attention_reference(
            view(q, 0, sq), view(k, 1, skv), view(v, 2, skv), scale, causal))


@pytest.fixture
def card_free_launch(monkeypatch):
    """The launch path with the device check and the kernel replaced."""
    checked = []
    monkeypatch.setattr(A, "_check_kernel_inputs",
                        lambda what, q, ts: checked.append([t.dtype for _, t in ts]))
    monkeypatch.setattr(A, "_flash_f32_launch", strided_attention)
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
