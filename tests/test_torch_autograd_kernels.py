"""The autograd Functions of the port's kernel entry points
(`ops/autograd.KernelWithPlainBackward` behind `flash_attention`,
`flash_attention_packed` and `group_norm`), driven on the CPU with the
plain forward in place of the launch (`forward=`): their gradients with
respect to every input against `jax.vjp` of what JAX's `custom_vjp`
backward differentiates (`_xla_attention`, `_einsum_bsnd`,
`group_norm_reference`), within 1e-5 * (1 + max|ref|); and
`torch.autograd.gradcheck` in float64 at toy shapes."""
import jax
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops.attention import _einsum_bsnd, _xla_attention
from faithdiff_tpu.ops.groupnorm import group_norm_reference as jax_group_norm
from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                               einsum_bsnd,
                                               flash_attention_function,
                                               flash_attention_packed_function)
from faithdiff_tpu_torch.ops.groupnorm import (group_norm_function,
                                               group_norm_plain)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Toy shapes run no faster on more threads, and in the 6-worker test
    run each worker's thread pool would spin on the shared cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= TOL * (1 + np.abs(ref).max()), err


def _leaves(*arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


class _Spy:
    """A forward that counts its calls and returns the plain version's."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("causal,sq,skv", [(False, 20, 28), (True, 24, 24)])
def test_flash_attention_function_grads_match_jax(causal, sq, skv):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, skv, 16)).astype(np.float32)
    g = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v, 0.25, causal),
                     q, k, v)
    ref = vjp(g)

    tq, tk, tv = _leaves(q, k, v)
    spy = _Spy(attention_reference)
    out = flash_attention_function(tq, tk, tv, 0.25, causal, forward=spy)
    assert type(out.grad_fn).__name__ == "KernelWithPlainBackwardBackward"
    out.backward(torch.from_numpy(g))
    assert spy.calls == 1          # the backward recomputes the plain version
    for t, r in zip((tq, tk, tv), ref):
        _close(t.grad, r)


def test_flash_attention_packed_function_grads_match_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 20, 48)).astype(np.float32)
    k = rng.standard_normal((2, 28, 48)).astype(np.float32)
    v = rng.standard_normal((2, 28, 48)).astype(np.float32)
    g = rng.standard_normal((2, 20, 48)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: _einsum_bsnd(q, k, v, 3, 0.25), q, k, v)
    ref = vjp(g)

    tq, tk, tv = _leaves(q, k, v)
    out = flash_attention_packed_function(tq, tk, tv, 3, 0.25,
                                          forward=einsum_bsnd)
    out.backward(torch.from_numpy(g))
    for t, r in zip((tq, tk, tv), ref):
        _close(t.grad, r)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("with_add", [False, True])
def test_group_norm_function_grads_match_jax(act, with_add):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 5, 6)).astype(np.float32) * 2 + 0.5
    scale = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    add = rng.standard_normal((2, 8)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    x_nhwc, g_nhwc = x.transpose(0, 2, 3, 1), g.transpose(0, 2, 3, 1)
    if with_add:
        _, vjp = jax.vjp(lambda x, s, b, a: jax_group_norm(
            x, s, b, 4, 1e-5, act, a), x_nhwc, scale, bias, add)
    else:
        _, vjp = jax.vjp(lambda x, s, b: jax_group_norm(x, s, b, 4, 1e-5, act),
                         x_nhwc, scale, bias)
    ref = vjp(g_nhwc)

    tx, ts, tb, ta = _leaves(x, scale, bias, add)
    out = group_norm_function(tx, ts, tb, 4, 1e-5, act,
                              ta if with_add else None,
                              forward=group_norm_plain)
    out.backward(torch.from_numpy(g))
    _close(tx.grad, np.asarray(ref[0]).transpose(0, 3, 1, 2))
    _close(ts.grad, ref[1])
    _close(tb.grad, ref[2])
    if with_add:
        _close(ta.grad, ref[3])
    else:
        assert ta.grad is None


def test_functions_under_no_grad_call_the_bare_forward():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    spy = _Spy(attention_reference)
    with torch.no_grad():
        out = flash_attention_function(q, q, q, 0.25, forward=spy)
    assert out.grad_fn is None and spy.calls == 1
    out = flash_attention_function(q.detach(), q.detach(), q.detach(), 0.25,
                                   forward=spy)
    assert out.grad_fn is None and spy.calls == 2


def _gradcheck(fn, *inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_gradcheck(causal):
    q, k, v = (torch.randn(1, 2, 5, 4, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    _gradcheck(lambda q, k, v: flash_attention_function(
        q, k, v, 0.4, causal, forward=attention_reference), q, k, v)


def test_flash_attention_packed_function_gradcheck():
    q = torch.randn(1, 5, 8, dtype=torch.float64, requires_grad=True)
    k = torch.randn(1, 6, 8, dtype=torch.float64, requires_grad=True)
    v = torch.randn(1, 6, 8, dtype=torch.float64, requires_grad=True)
    _gradcheck(lambda q, k, v: flash_attention_packed_function(
        q, k, v, 2, 0.4, forward=einsum_bsnd), q, k, v)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_function_gradcheck(act):
    x = torch.randn(2, 4, 3, 3, dtype=torch.float64, requires_grad=True)
    s = torch.randn(4, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, dtype=torch.float64, requires_grad=True)
    a = torch.randn(2, 4, dtype=torch.float64, requires_grad=True)
    _gradcheck(lambda x, s, b, a: group_norm_function(
        x, s, b, 2, 1e-5, act, a, forward=group_norm_plain), x, s, b, a)
