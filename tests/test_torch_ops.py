"""The port's attention and GroupNorm (CPU: the kernels' plain versions)
against the JAX package's Pallas kernels in interpret mode and its XLA
references. Inputs come from numpy and go to both sides; fp32 throughout,
so the tolerances only cover summation order."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faithdiff_tpu.ops import attention as jax_attention
from faithdiff_tpu.ops.attention import (_chunked_xla_attention,
                                         _flash_attention_fwd_impl,
                                         _xla_attention)
from faithdiff_tpu.ops.groupnorm import _fused_group_norm_fwd
from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                               chunked_attention,
                                               flash_attention,
                                               flash_eligible,
                                               multi_head_attention)
from faithdiff_tpu_torch.ops.groupnorm import group_norm


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,causal,scale", [
    ((1, 2, 256, 64), False, 1.0 / 8.0),
    ((1, 1, 256, 64), True, 0.125),
])
def test_plain_attention_matches_pallas_interpret_and_xla(shape, causal,
                                                          scale):
    q, k, v = _qkv(shape, 6)
    ours = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                           causal).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = _flash_attention_fwd_impl(
        jq, jk, jv, scale=scale, causal=causal, block_q=128, block_k=128,
        interpret=True)
    xla = _xla_attention(jq, jk, jv, scale, causal)
    # fp32 on both sides; the Pallas kernel's base-2 online softmax differs
    # from one softmax by rounding only (its own test allows 2e-5)
    np.testing.assert_allclose(ours, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(ours, np.asarray(xla), atol=1e-5)


def test_chunked_attention_matches_jax():
    q, k, v = _qkv((1, 2, 512, 32), 3)
    ours = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             0.2, chunk=128).numpy()
    want = _chunked_xla_attention(*(jnp.asarray(a) for a in (q, k, v)), 0.2,
                                  chunk=128)
    # the same online-softmax recurrence in fp32: rounding only
    np.testing.assert_allclose(ours, np.asarray(want), atol=1e-5)


def test_cpu_dispatch_runs_plain_version_and_launches_nothing():
    """A flash-eligible shape (seq >= 1024, d = 64) on CPU tensors goes
    through the wrapper's plain version: bit-equal to it, no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 1024, 64), 9))
    _build.launches.clear()
    out = multi_head_attention(q, k, v)
    assert torch.equal(out, attention_reference(q, k, v, 0.125))
    assert _build.launches["flash_attention_fwd"] == 0
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("shape,g,eps,act,with_add", [
    ((2, 8, 8, 64), 8, 1e-5, None, False),
    ((1, 6, 10, 96), 32, 1e-6, None, False),
    ((2, 16, 4, 128), 32, 1e-5, "silu", True),
    ((2, 8, 8, 64), 8, 1e-6, "silu", False),
    ((1, 6, 10, 96), 32, 1e-5, None, True),
])
def test_group_norm_matches_pallas_interpret(shape, g, eps, act, with_add):
    rng = np.random.default_rng(0)
    b, c = shape[0], shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)   # NHWC
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    add = (rng.standard_normal((b, c)) * 0.5).astype(np.float32) \
        if with_add else None
    want = _fused_group_norm_fwd(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        None if add is None else jnp.asarray(add), g, eps, act,
        interpret=True)
    _build.launches.clear()
    ours = group_norm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                      torch.from_numpy(scale), torch.from_numpy(bias), g, eps,
                      act, None if add is None else torch.from_numpy(add))
    assert sum(_build.launches.values()) == 0
    # fp32 statistics on both sides, summed in another order (the JAX
    # package's own fused-vs-reference test allows 1e-5)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-5)


def _jax_flash_shapes(monkeypatch):
    """The table of BHSD shapes JAX's `multi_head_attention` sends to its
    flash kernel on a TPU, read from its own gate: `_on_tpu` forced true
    and the three attention bodies replaced by recorders, traced with
    `jax.eval_shape` (nothing is computed)."""
    taken = []

    def recorder(name):
        def body(q, *args, **kwargs):
            taken.append(name)
            return q
        return body

    monkeypatch.setattr(jax_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax_attention, "_flash_attention", recorder("flash"))
    monkeypatch.setattr(jax_attention, "_xla_attention", recorder("xla"))
    monkeypatch.setattr(jax_attention, "_chunked_xla_attention",
                        recorder("chunked"))
    table = []
    # the head dims of the repo's models that reach attention: 64 (UNet,
    # CLIP) and 128 (LLaMA / MPT prefill); lengths around the gate's edges
    for d in (64, 128):
        for sq in (512, 1000, 1024, 1152, 2048, 4096, 8192):
            for skv in (77, 1024, 1030, 4096, 8192):
                for causal in (False, True):
                    if causal and sq != skv:
                        continue
                    taken.clear()
                    q = jax.ShapeDtypeStruct((1, 2, sq, d), jnp.bfloat16)
                    kv = jax.ShapeDtypeStruct((1, 2, skv, d), jnp.bfloat16)
                    jax.eval_shape(functools.partial(
                        jax_attention.multi_head_attention, causal=causal),
                        q, kv, kv)
                    table.append(((1, 2, sq, d), (1, 2, skv, d), causal,
                                  taken == ["flash"]))
    return table


def test_flash_gate_takes_every_shape_jax_sends_to_its_kernel(monkeypatch):
    """Every shape of the table that JAX sends to `_flash_kernel` goes to
    the port's flash kernel too, d = 128 (the LLaMA prefill) included; the
    port also serves lengths that are no multiple of 128 and K/V beyond the
    TPU's VMEM cap, which its kernel streams."""
    table = _jax_flash_shapes(monkeypatch)
    jax_flash = [(qs, ks) for qs, ks, _, flash in table if flash]
    assert any(qs[-1] == 128 for qs, _ in jax_flash)
    assert ((1, 2, 1024, 128), (1, 2, 1024, 128)) in jax_flash
    for qs, ks in jax_flash:
        assert flash_eligible(torch.empty(qs, device="meta"),
                              torch.empty(ks, device="meta")), (qs, ks)
    # below 1024 tokens on either side (cross-attention, CLIP) stays plain
    for qs, ks, _, _ in table:
        if min(qs[2], ks[2]) < 1024:
            assert not flash_eligible(torch.empty(qs, device="meta"),
                                      torch.empty(ks, device="meta"))


def test_library_name_follows_only_the_headers_a_source_includes(
        monkeypatch, tmp_path):
    """A header change renames (and so rebuilds) the libraries whose source
    includes it, directly or through another header, and no other."""
    (tmp_path / "a.cu").write_text('#include "outer.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cstdint>\nint b;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert _build._sources_of("a") == ["a.cu", "outer.cuh", "inner.cuh"]
    assert _build._sources_of("b") == ["b.cu"]
    before = {n: _build._lib_path(n) for n in "ab"}
    (tmp_path / "inner.cuh").write_text("#pragma once\n// changed\n")
    assert _build._lib_path("a") != before["a"]
    assert _build._lib_path("b") == before["b"]
