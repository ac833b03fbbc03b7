"""The port's attention variants (`ops/attention_variants.py`; CPU: the
kernel's plain version) against the kernel of the JAX package's variant
benchmark (`scripts/bench_attention_variants.py`) run by Pallas in
interpret mode, for each (base2, block_k) the port's kernel has. fp32
inputs from numpy on both sides."""
import functools
import importlib.util
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops.attention_variants import (
    VARIANTS, attention_variant, attention_variant_reference)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# what importing the benchmark script sets
_SCRIPT_CONFIG = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def bench_kernel():
    """The script's `kernel`, imported by path (`scripts/` is no package);
    the config values and `sys.path` entry its import sets are put back."""
    saved = {name: getattr(jax.config, name) for name in _SCRIPT_CONFIG}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "_bench_attention_variants_jax",
        ROOT / "scripts" / "bench_attention_variants.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        sys.path[:] = path
    return module.kernel


def _pallas_interpret(kernel, q, k, v, scale, bq, bk, base2):
    """The script's `run` around its `kernel`, with `interpret=True`."""
    bh, q_len, d = q.shape
    kv_len = k.shape[1]
    return pl.pallas_call(
        functools.partial(kernel, scale=scale, block_k=bk, base2=base2),
        grid=(bh, q_len // bq),
        in_specs=[pl.BlockSpec((1, bq, d), lambda b, i: (b, i, 0)),
                  pl.BlockSpec((1, kv_len, d), lambda b, i: (b, 0, 0)),
                  pl.BlockSpec((1, kv_len, d), lambda b, i: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, d), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        interpret=True)(q, k, v)


@pytest.mark.parametrize("base2,block_k", VARIANTS)
def test_variant_plain_matches_bench_kernel_interpret(bench_kernel, base2,
                                                      block_k):
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 256, 64)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / math.sqrt(64)
    _build.launches.clear()
    ours = attention_variant(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                             base2, block_k)
    assert sum(_build.launches.values()) == 0
    assert torch.equal(ours, attention_variant_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), scale, base2))
    # block_k < kv_len: the Pallas kernel's online softmax runs 2-4 blocks
    want = _pallas_interpret(bench_kernel, *(jnp.asarray(a) for a in (q, k, v)),
                             scale, 128, block_k, base2)
    # fp32 on both sides: an online softmax against one softmax differs by
    # rounding only (as the flash kernel's parity test)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("base2", [False, True])
def test_variant_plain_matches_bench_kernel_in_bf16(bench_kernel, base2):
    """In bf16 the variants differ (the base-2 fold rounds q * scale *
    log2 e to bf16): each plain variant agrees with the same variant of
    the script's kernel, single pass (block_k == kv_len), where the other
    variant does not."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 256, 64)).astype(np.float32)
               for _ in range(3))
    ours = attention_variant_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 0.125, base2)
    want = _pallas_interpret(
        bench_kernel, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        0.125, 128, 256, base2)
    # fp32 sums in another order can move an output's one bf16 rounding
    # by a step (2^-8 relative); the other variant misses by ~8x that
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-4)


def test_bench_raises_without_a_cuda_card(monkeypatch):
    """The benchmark's entry point, like the JAX script's assert on a TPU,
    refuses to run where there is no card."""
    from faithdiff_tpu_torch.scripts import bench_attention_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_attention_variants.main()
