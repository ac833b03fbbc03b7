"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where torch.cuda.is_available() is false.
Imports no JAX, so the file also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import ctypes
import dataclasses
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from faithdiff_tpu_torch.ops import _build
from faithdiff_tpu_torch.ops import attention as A
from faithdiff_tpu_torch.ops.attention import (attention_packed,
                                               attention_reference,
                                               einsum_bsnd, flash_attention,
                                               flash_attention_packed,
                                               flash_attention_tiled,
                                               multi_head_attention)
from faithdiff_tpu_torch.ops.attention_variants import (
    VARIANTS, attention_variant, attention_variant_reference)
from faithdiff_tpu_torch.ops.groupnorm import (GroupNormLaunch, group_norm,
                                               group_norm_reference,
                                               group_stats_reference,
                                               plan_group_norm)
from faithdiff_tpu_torch.ops.nf4_matmul import (nf4_gemm_tiled,
                                                nf4_gemv_tiled,
                                                nf4_matmul_kernel,
                                                nf4_matmul_reference,
                                                plan_nf4_gemm,
                                                plan_nf4_gemv)
from faithdiff_tpu_torch.utils.quantize import (NF4_PACK_PAIRWISE, NF4Weight,
                                                dequantize_nf4, nf4_matmul,
                                                quantize_nf4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _within(out, ref):
    # a few bf16 rounding steps: q is rounded after the scale fold and p
    # before p.v at other points than in the plain version
    err = (out.float() - ref.float()).abs()
    return bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())


@pytest.mark.parametrize("b,h,sq,skv,causal", [
    (1, 2, 1024, 1024, False), (1, 2, 1024, 1024, True),
    (2, 1, 1000, 1100, False), (1, 3, 1030, 1030, True),
    (2, 3, 1000, 1100, False),          # partial q block and K/V tile
    (1, 2, 50, 1100, False), (1, 2, 77, 100, False),    # q under one group
    (1, 70000, 8, 16, False)])          # more planes than a grid's y extent
def test_flash_attention_matches_plain(cuda, b, h, sq, skv, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, h, sq, 64), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, h, skv, 64), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, h, skv, 64), generator=g, device=cuda).bfloat16()
    _build.launches.clear()
    out = flash_attention(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_fwd"] == 1
    assert _within(out, attention_reference(q, k, v, 0.125, causal))


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.randn((1, 1, 1024, 64), device=cuda).bfloat16()
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(TypeError):          # mixed dtypes
        flash_attention(q, q.float(), q, 0.125)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :1000].contiguous(),
                        q[:, :, :1000].contiguous(), 0.125, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), q, q, 0.125)
    with pytest.raises(ValueError):
        # d = 32 is not a kernel shape; the dispatch keeps it plain
        flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                        q[..., :32].contiguous(), 0.125)
    unaligned = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    with pytest.raises(ValueError):
        flash_attention(unaligned.view(q.shape), q, q, 0.125)


def test_dispatch_sends_long_self_attention_to_the_kernel(cuda):
    q = torch.randn((2, 4, 1024, 64), device=cuda).bfloat16()
    ctx = torch.randn((2, 4, 77, 64), device=cuda).bfloat16()
    _build.launches.clear()
    multi_head_attention(q, q, q)
    multi_head_attention(q, ctx, ctx)            # cross-attention: plain
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_fwd"] == 1


@pytest.mark.parametrize("b,h,sq,skv,causal", [
    (2, 40, 1024, 1024, True),          # the 13B LLaMA prefill
    (1, 2, 1030, 1030, True), (1, 3, 1000, 1100, False),
    (2, 3, 1000, 1100, False), (1, 3, 1030, 1030, True), (1, 2, 40, 77, False)])
def test_flash_attention_d128_matches_plain(cuda, b, h, sq, skv, causal):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((b, h, sq, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, h, skv, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, h, skv, 128), generator=g, device=cuda).bfloat16()
    _build.launches.clear()
    out = flash_attention(q, k, v, 128 ** -0.5, causal)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_fwd"] == 1
    assert _within(out, attention_reference(q, k, v, 128 ** -0.5, causal))


def _within_f32(out, ref):
    # the fp32 kernel sums in another order and exponentiates in base 2
    err = (out - ref).abs().max()
    return bool(torch.isfinite(out).all()) and float(err) <= 2e-5 * float(ref.abs().max())


@pytest.fixture
def no_tf32():
    # the fp32 plain version in full fp32, as the kernel computes
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,sq,skv,causal", [
    (2, 10, 1024, 1024, False), (1, 2, 1024, 1024, True),
    (2, 3, 1000, 1100, False),          # partial q block and K/V tile
    (1, 3, 1030, 1030, True), (1, 2, 50, 1100, False), (1, 2, 77, 100, False)])
def test_flash_attention_f32_matches_plain(cuda, no_tf32, d, b, h, sq, skv, causal):
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn((b, h, sq, d), generator=g, device=cuda)
    k = torch.randn((b, h, skv, d), generator=g, device=cuda)
    v = torch.randn((b, h, skv, d), generator=g, device=cuda)
    _build.launches.clear()
    out = flash_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert _build.launches["flash_attention_f32_fwd"] == 1
    assert _build.launches["flash_attention_fwd"] == 0
    assert _within_f32(out, attention_reference(q, k, v, d ** -0.5, causal))


@pytest.mark.parametrize("b,heads,sq,skv,d", [
    (2, 10, 1024, 1024, 64), (1, 2, 1000, 1100, 64), (2, 2, 1030, 77, 64),
    (1, 2, 1024, 1030, 128), (2, 1, 100, 1000, 128), (1, 2, 40, 77, 128)])
def test_flash_attention_packed_f32_matches_plain(cuda, no_tf32, b, heads, sq, skv, d):
    g = torch.Generator(device=cuda).manual_seed(13)
    f = heads * d
    # q a column slice of a fused [b, sq, 3f] projection: a row stride of 3f
    q = torch.randn((b, sq, 3 * f), generator=g, device=cuda)[..., f:2 * f]
    k = torch.randn((b, skv, f), generator=g, device=cuda)
    v = torch.randn((b, skv, f), generator=g, device=cuda)
    _build.launches.clear()
    out = flash_attention_packed(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.is_contiguous()
    assert _build.launches["flash_attention_f32_bsnd_fwd"] == 1
    assert _within_f32(out, einsum_bsnd(q.contiguous(), k, v, heads, d ** -0.5))


@pytest.mark.parametrize("splits", [1, 2, None], ids=["1split", "2splits", "planned"])
@pytest.mark.parametrize("layout,causal", [("bhsd", False), ("bhsd", True),
                                           ("packed", False)])
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_flash_attention_f32_splits_same_bits(cuda, no_tf32, monkeypatch, d, layout,
                                              causal, splits):
    """The fp32 kernel at one split, two and its plan's count (forced
    through `f32_plan`), ragged BHSD lengths, causal, and packed column
    slices: within 2e-5 * max|ref| of the plain version, the same bits on
    a second call, and the merge launched exactly when the K/V range is
    split."""
    monkeypatch.setattr(A, "f32_plan", functools.partial(A.f32_plan, splits=splits))
    g = torch.Generator(device=cuda).manual_seed(d + (splits or 0))
    if layout == "bhsd":
        b, h, sq, skv = (1, 2, 1030, 1030) if causal else (2, 2, 1000, 1100)
        q = torch.randn((b, h, sq, d), generator=g, device=cuda)
        k, v = (torch.randn((b, h, skv, d), generator=g, device=cuda) for _ in range(2))
        run = lambda: flash_attention(q, k, v, d ** -0.5, causal)  # noqa: E731
        ref = attention_reference(q, k, v, d ** -0.5, causal)
        counter = A._strided_counter(torch.float32, d, False)
    else:
        b, h, sq, skv, f = 2, 2, 1030, 1100, 2 * d
        q = torch.randn((b, sq, 3 * f), generator=g, device=cuda)[..., f:2 * f]
        k, v = torch.randn((b, skv, 2 * f), generator=g, device=cuda).split(f, dim=-1)
        run = lambda: flash_attention_packed(q, k, v, h, d ** -0.5)  # noqa: E731
        ref = einsum_bsnd(q.contiguous(), k.contiguous(), v.contiguous(), h, d ** -0.5)
        counter = A._strided_counter(torch.float32, d, True)
    plan = A.f32_plan(b, h, sq, skv, d, causal)
    assert splits is None or plan.splits == splits
    _build.launches.clear()
    out, again = run(), run()
    torch.cuda.synchronize()
    merged = 2 if plan.splits > 1 else 0
    assert dict(_build.launches) == {counter: 2, **(
        {"flash_attention_f32_merge": merged} if merged else {})}
    assert _within_f32(out, ref)
    assert torch.equal(out, again)


@pytest.mark.parametrize("splits", [1, 2, None], ids=["1split", "2splits", "planned"])
@pytest.mark.parametrize("shape", [(2, 1, 1024, 512), (1, 1, 1024, 512)], ids=str)
def test_flash_attention_f32_path_shapes_splits_same_bits(cuda, no_tf32, monkeypatch,
                                                         shape, splits):
    """The fp32 kernel at the d = 512 attentions of its paths (the 256 px
    trainer's batch of 2, planned at 4 splits, and the VAE's one), at one
    split, two and the plan's count: within 2e-5 * max|ref| of the plain
    version and the same bits on a second call."""
    monkeypatch.setattr(A, "f32_plan", functools.partial(A.f32_plan, splits=splits))
    g = torch.Generator(device=cuda).manual_seed(shape[0] + (splits or 0))
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    b, h, s, d = shape
    plan = A.f32_plan(b, h, s, s, d)
    assert splits is None or plan.splits == splits
    _build.launches.clear()
    out, again = flash_attention(q, k, v, d ** -0.5), flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    merged = 2 if plan.splits > 1 else 0
    assert dict(_build.launches) == {"flash_attention_f32_wide_fwd": 2, **(
        {"flash_attention_f32_merge": merged} if merged else {})}
    assert _within_f32(out, attention_reference(q, k, v, d ** -0.5))
    assert torch.equal(out, again)


@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("d", [64, 512])
def test_flash_attention_f32_entry_refuses_rows_off_its_layout(cuda, d, splits):
    """The fp32 entry point takes the partial buffers' rows a plane only as
    its 64-row q blocks give them: one q block more or fewer is refused
    before anything launches, with one split or eight."""
    b, h, s = 1, 1, 1024
    q, k, v = (torch.randn((b, h, s, d), device=cuda) for _ in range(3))
    out = torch.empty_like(q)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    plan = A.f32_plan(b, h, s, s, d, splits=splits)
    launch = functools.partial(A._wide_fwd_launch, q, k, v, out, strides,
                               (b, h, s, s, d), d ** -0.5, False,
                               source="flash_attention_f32")
    launch(plan)
    torch.cuda.synchronize()
    for q_blocks in (plan.q_blocks - 1, plan.q_blocks + 1):
        with pytest.raises(RuntimeError, match="fd_flash_attention_f32_fwd"):
            launch(plan._replace(q_blocks=q_blocks))


def _packed(cuda, b, sq, skv, f, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((b, sq, f), generator=g, device=cuda).bfloat16(),
            torch.randn((b, skv, f), generator=g, device=cuda).bfloat16(),
            torch.randn((b, skv, f), generator=g, device=cuda).bfloat16())


@pytest.mark.parametrize("b,heads,sq,skv,d", [
    (2, 3, 1024, 1024, 64), (1, 2, 1000, 1100, 64),   # partial q / kv tiles
    (2, 2, 1030, 77, 64), (1, 2, 1024, 1030, 128), (2, 1, 100, 1000, 128),
    (2, 2, 50, 1100, 64), (1, 2, 40, 77, 128)])        # q under one group
def test_flash_attention_packed_matches_plain(cuda, b, heads, sq, skv, d):
    q, k, v = _packed(cuda, b, sq, skv, heads * d, 4)
    _build.launches.clear()
    out = flash_attention_packed(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention_bsnd_fwd"] == 1
    assert out.shape == q.shape and out.is_contiguous()
    assert _within(out, einsum_bsnd(q, k, v, heads, d ** -0.5))


def test_flash_attention_packed_takes_column_slices(cuda):
    """q/k/v as column slices of one fused [b, s, 3f] projection: packed
    rows with a row stride of 3f."""
    qkv = _packed(cuda, 2, 1024, 1024, 3 * 128, 5)[0]
    q, k, v = qkv.split(128, dim=-1)
    out = flash_attention_packed(q, k, v, 2, 0.125)
    assert _within(out, einsum_bsnd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), 2, 0.125))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv", [(1030, 77), (50, 1100)])
def test_flash_attention_packed_takes_ragged_column_slices(cuda, d, sq, skv):
    """q a column slice of a fused [b, s, 3f] projection, k and v of a
    [b, skv, 2f] one, at lengths that leave partial blocks and tiles."""
    f = 2 * d
    q = _packed(cuda, 2, sq, sq, 3 * f, 9)[0][..., f:2 * f]
    k, v = _packed(cuda, 2, skv, skv, 2 * f, 10)[0].split(f, dim=-1)
    out = flash_attention_packed(q, k, v, 2, d ** -0.5)
    assert out.shape == q.shape and out.is_contiguous()
    assert _within(out, einsum_bsnd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), 2, d ** -0.5))


WIDE_DIMS = (192, 256, 320, 384, 448, 512)
WIDE_COUNTER = {torch.bfloat16: "flash_attention_wide", torch.float32: "flash_attention_f32_wide"}


def _wide_merges(dtype, b, h, sq, skv, d, causal) -> dict:
    """The merge launch a wide call adds where its kernel's plan splits the
    K/V range: the bf16 kernel's (`wide_plan`) or the fp32 one's
    (`f32_plan`)."""
    sms = A._sm_count(torch.device("cuda"))
    if dtype == torch.bfloat16:
        plan, name = A.wide_plan(b, h, sq, skv, d, causal, sms=sms), "flash_attention_wide_merge"
    else:
        plan, name = A.f32_plan(b, h, sq, skv, d, causal, sms=sms), "flash_attention_f32_merge"
    return {name: 1} if plan.splits > 1 else {}


@pytest.mark.parametrize("splits", [1, 2, None], ids=["1split", "2splits", "planned"])
@pytest.mark.parametrize("layout,causal", [("bhsd", False), ("bhsd", True),
                                           ("packed", False)])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_attention_wide_bf16_splits_same_bits(cuda, monkeypatch, d, layout,
                                                    causal, splits):
    """The bf16 wide kernel at one split, two and its plan's count (forced
    through `wide_plan`), ragged BHSD lengths, causal, and packed column
    slices: within the bf16 tolerance of the plain version, the same bits
    on a second call, and the merge launched exactly when the K/V range is
    split."""
    monkeypatch.setattr(A, "wide_plan", functools.partial(A.wide_plan, splits=splits))
    g = torch.Generator(device=cuda).manual_seed(d + (splits or 0))
    if layout == "bhsd":
        b, h, sq, skv = (1, 2, 1030, 1030) if causal else (2, 2, 1000, 1100)
        q = torch.randn((b, h, sq, d), generator=g, device=cuda).bfloat16()
        k, v = (torch.randn((b, h, skv, d), generator=g, device=cuda).bfloat16()
                for _ in range(2))
        run = lambda: flash_attention(q, k, v, d ** -0.5, causal)  # noqa: E731
        ref = attention_reference(q, k, v, d ** -0.5, causal)
        counter = "flash_attention_wide_fwd"
    else:
        b, h, sq, skv, f = 2, 2, 1030, 1100, 2 * d
        q = torch.randn((b, sq, 3 * f), generator=g, device=cuda).bfloat16()[..., f:2 * f]
        k, v = torch.randn((b, skv, 2 * f), generator=g, device=cuda).bfloat16().split(
            f, dim=-1)
        run = lambda: flash_attention_packed(q, k, v, h, d ** -0.5)  # noqa: E731
        ref = einsum_bsnd(q.contiguous(), k.contiguous(), v.contiguous(), h, d ** -0.5)
        counter = "flash_attention_wide_bsnd_fwd"
    plan = A.wide_plan(b, h, sq, skv, d, causal)
    assert splits is None or plan.splits == splits
    _build.launches.clear()
    out, again = run(), run()
    torch.cuda.synchronize()
    merged = 2 if plan.splits > 1 else 0
    assert dict(_build.launches) == {counter: 2, **(
        {"flash_attention_wide_merge": merged} if merged else {})}
    assert _within(out, ref)
    assert torch.equal(out, again)


@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("d", [256, 512])
def test_flash_attention_wide_entry_refuses_rows_off_its_layout(cuda, d, splits):
    """The entry point takes the partial buffers' rows a plane only as its
    own layout's q blocks give them: one q block more or fewer is refused
    before anything launches, with one split or eight."""
    b, h, s = 1, 1, 1024
    q, k, v = (torch.randn((b, h, s, d), device=cuda).bfloat16() for _ in range(3))
    out = torch.empty_like(q)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    plan = A.wide_plan(b, h, s, s, d, splits=splits)
    launch = functools.partial(A._wide_fwd_launch, q, k, v, out, strides,
                               (b, h, s, s, d), d ** -0.5, False)
    launch(plan)
    torch.cuda.synchronize()
    for q_blocks in (plan.q_blocks - 1, plan.q_blocks + 1):
        with pytest.raises(RuntimeError, match="fd_flash_attention_wide_fwd"):
            launch(plan._replace(q_blocks=q_blocks))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("b,h,sq,skv,causal", [
    (1, 1, 1024, 1024, False),          # the VAE mid-attention at d = 512
    (2, 2, 1000, 1100, False), (1, 2, 1030, 1030, True), (1, 1, 40, 77, False)])
def test_flash_attention_wide_matches_plain(cuda, no_tf32, dtype, d, b, h, sq, skv,
                                            causal):
    g = torch.Generator(device=cuda).manual_seed(17)
    q = torch.randn((b, h, sq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, h, skv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, h, skv, d), generator=g, device=cuda).to(dtype)
    _build.launches.clear()
    out = flash_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {WIDE_COUNTER[dtype] + "_fwd": 1,
                                     **_wide_merges(dtype, b, h, sq, skv, d, causal)}
    within = _within if dtype == torch.bfloat16 else _within_f32
    assert within(out, attention_reference(q, k, v, d ** -0.5, causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("sq,skv", [(1030, 77), (1024, 1024)])
def test_flash_attention_packed_wide_takes_column_slices(cuda, no_tf32, dtype, d,
                                                         sq, skv):
    g = torch.Generator(device=cuda).manual_seed(18)
    heads, f = 2, 2 * d
    q = torch.randn((2, sq, 3 * f), generator=g, device=cuda).to(dtype)[..., f:2 * f]
    k, v = torch.randn((2, skv, 2 * f), generator=g, device=cuda).to(dtype).split(f, dim=-1)
    _build.launches.clear()
    out = flash_attention_packed(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {WIDE_COUNTER[dtype] + "_bsnd_fwd": 1,
                                     **_wide_merges(dtype, 2, heads, sq, skv, d, False)}
    within = _within if dtype == torch.bfloat16 else _within_f32
    assert within(out, einsum_bsnd(q.contiguous(), k.contiguous(), v.contiguous(),
                                   heads, d ** -0.5))


def test_flash_attention_wide_rejects_what_it_does_not_take(cuda):
    q = torch.randn((1, 1, 1024, 576), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="ROADMAP §2"):
        flash_attention(q, q, q, 0.04)
    q = torch.randn((1, 1, 1024, 200), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head dim 200"):
        flash_attention(q, q, q, 0.07)


def test_vae_attention_runs_the_wide_kernel_at_a_32_latent(cuda):
    """The VAE mid-attention takes the d = 512 kernel at a 32 x 32 latent
    and `chunked_attention` at 64 x 64, as JAX's gate routes it."""
    from faithdiff_tpu_torch.models.unet_blocks import VaeAttention

    torch.manual_seed(0)
    attn = VaeAttention(512).to(cuda, torch.bfloat16).eval()
    for side, launched in ((32, 1), (64, 0)):
        x = torch.randn((1, 512, side, side), device=cuda).bfloat16()
        _build.launches.clear()
        with torch.no_grad():
            out = attn(x)
        torch.cuda.synchronize()
        assert _build.launches["flash_attention_wide_fwd"] == launched
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("d,causal", [(64, True), (64, False), (128, True)])
def test_flash_attention_matches_its_tile_walk(cuda, d, causal):
    """The kernel against the plain walk of its own schedule: the same
    tiles, masks and bf16 roundings, so the sums' order and the hardware
    exp2 are all that differ."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((1, 2, 1030, d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    out = flash_attention(q, k, v, d ** -0.5, causal)
    assert _within(out, flash_attention_tiled(q, k, v, d ** -0.5, causal))


def test_flash_attention_packed_rejects_what_it_does_not_take(cuda):
    q, k, v = _packed(cuda, 1, 1024, 1024, 128, 6)
    with pytest.raises(TypeError):
        flash_attention_packed(q.half(), k.half(), v.half(), 2, 0.125)
    with pytest.raises(TypeError):          # mixed dtypes
        flash_attention_packed(q.float(), k, v, 2, 0.125)
    with pytest.raises(ValueError):         # head dim 32
        flash_attention_packed(q, k, v, 4, 0.125)
    with pytest.raises(ValueError):         # heads do not divide n*d
        flash_attention_packed(q, k, v, 3, 0.125)
    with pytest.raises(ValueError):         # column stride 2
        wide = torch.zeros((1, 1024, 256), device=cuda).bfloat16()
        flash_attention_packed(wide[..., ::2], k, v, 2, 0.125)
    with pytest.raises(ValueError):         # rows do not start on 16 bytes
        odd = torch.zeros((1, 1024, 132), device=cuda).bfloat16()
        flash_attention_packed(odd[..., :128], k, v, 2, 0.125)
    with pytest.raises(ValueError):         # k and v disagree
        flash_attention_packed(q, k, v[:, :1000], 2, 0.125)
    unaligned = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    with pytest.raises(ValueError):
        flash_attention_packed(unaligned.view(q.shape), k, v, 2, 0.125)


def test_attention_packed_sends_long_self_attention_to_the_kernel(cuda):
    x = _packed(cuda, 2, 4096, 77, 640, 7)
    _build.launches.clear()
    attention_packed(x[0], x[0], x[0], 10)      # self-attention: the kernel
    attention_packed(x[0], x[1], x[2], 10)      # 77-token cross: plain
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"flash_attention_bsnd_fwd": 1}


@pytest.mark.parametrize("base2,block_k", VARIANTS)
def test_attention_variant_matches_plain(cuda, base2, block_k):
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn((3, 1030, 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    _build.launches.clear()
    out = attention_variant(q, k, v, 0.125, base2, block_k)
    torch.cuda.synchronize()
    assert _build.launches["attention_variant_fwd"] == 1
    assert _within(out, attention_variant_reference(q, k, v, 0.125, base2))


def test_attention_variant_rejects_what_it_does_not_take(cuda):
    q = torch.randn((2, 1024, 64), device=cuda).bfloat16()
    with pytest.raises(ValueError):
        attention_variant(q, q, q, 0.125, True, 256)
    with pytest.raises(TypeError):
        attention_variant(q.float(), q.float(), q.float(), 0.125, True, 64)
    with pytest.raises(ValueError):
        attention_variant(q[..., :32].contiguous(), q[..., :32].contiguous(),
                          q[..., :32].contiguous(), 0.125, True, 64)


def _gn_inputs(cuda, shape, dtype, with_add, seed=1):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (2 * torch.randn(shape, generator=gen, device=cuda) + 0.3).to(dtype)
    c = shape[1]
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(c, generator=gen, device=cuda)
    add = torch.randn((shape[0], c), generator=gen, device=cuda) \
        if with_add else None
    return x, scale, bias, add


def _implied_stats(x, y, g, add=None):
    """Per-group mean and E[v^2] that an output y = (v - mean) * rstd (scale
    1, bias 0, no act) implies, v = x + add: rstd by least squares of y on
    v, in float64."""
    b, c = x.shape[:2]
    v = x.double().reshape(b, c, -1)
    if add is not None:
        v = v + add.double().reshape(b, c, 1)
    v, y = v.reshape(b, g, -1), y.double().reshape(b, g, -1)
    vc, yc = v - v.mean(-1, keepdim=True), y - y.mean(-1, keepdim=True)
    rstd = (vc * yc).sum(-1) / vc.square().sum(-1)
    mean = v.mean(-1) - y.mean(-1) / rstd
    return mean, v.square().mean(-1)


@pytest.mark.parametrize("shape,g,dtype,act,with_add", [
    ((2, 64, 16, 16), 32, torch.bfloat16, "silu", True),
    ((1, 32, 5, 7), 8, torch.bfloat16, None, False),       # HW % 8 != 0
    ((2, 64, 16, 16), 32, torch.float32, "silu", False),
    ((1, 96, 33, 31), 32, torch.float16, None, True),
    ((1, 128, 256, 384), 32, torch.bfloat16, "silu", False)])
def test_group_norm_matches_plain(cuda, shape, g, dtype, act, with_add):
    x, scale, bias, add = _gn_inputs(cuda, shape, dtype, with_add)
    _build.launches.clear()
    out = group_norm(x, scale, bias, g, 1e-6, act, add)
    torch.cuda.synchronize()
    plan = plan_group_norm(shape, x.element_size(), g)
    assert dict(_build.launches) == {name: 1 for name in plan.counters}
    assert _within(out, group_norm_reference(x, scale, bias, g, 1e-6, act, add))
    again = group_norm(x, scale, bias, g, 1e-6, act, add)
    assert torch.equal(out, again)              # no atomics: same bits


# [C, H] of each GroupNorm of the full-width UNet at a 128^2 latent tile
UNET_GN = [(512, 128), (320, 128), (640, 128), (960, 128), (320, 64),
           (640, 64), (960, 64), (1280, 64), (1920, 64), (640, 32),
           (1280, 32), (1920, 32), (2560, 32)]


@pytest.mark.parametrize("c,side", UNET_GN)
def test_group_norm_single_pass_at_unet_shapes(cuda, c, side):
    """UNet batch 4 (two tiles' CFG pairs), bf16 with bf16 scale, bias and
    add as the model holds them: one launch, within a bf16 step of the
    plain version, and the statistics within 1e-4 (from an fp32 run with
    scale 1 and bias 0)."""
    shape = (4, c, side, side)
    x, scale, bias, add = _gn_inputs(cuda, shape, torch.bfloat16, True)
    scale, bias, add = scale.bfloat16(), bias.bfloat16(), add.bfloat16()
    assert plan_group_norm(shape, 2, 32).route == "fused"
    _build.launches.clear()
    out = group_norm(x, scale, bias, 32, 1e-5, "silu", add)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"group_norm_fused": 1}
    assert _within(out, group_norm_reference(x, scale, bias, 32, 1e-5, "silu", add))
    assert torch.equal(out, group_norm(x, scale, bias, 32, 1e-5, "silu", add))
    x32 = x.float()
    y32 = group_norm(x32, torch.ones_like(scale), torch.zeros_like(bias), 32,
                     1e-5, None, add)
    mean, m2 = _implied_stats(x32, y32, 32, add)
    gs1, gs2 = group_stats_reference(x32, 32, add)
    n = gs1.new_tensor(x[0, 0].numel() * c // 32).double()
    assert float((mean - gs1.double() / n).abs().max()) <= 1e-4
    assert float((m2 - gs2.double() / n).abs().max()) <= 1e-4


def test_group_norm_both_routes_past_65535_rows(cuda):
    """[30, 2560, 32, 32]: B*C = 76,800 rows, more than a grid's y extent
    holds (the 15-tile restore's largest ResNet norm). Both routes, with
    add and SiLU; the two-pass route through the launch's own method."""
    shape = (30, 2560, 32, 32)
    x, scale, bias, add = _gn_inputs(cuda, shape, torch.bfloat16, True)
    ref = group_norm_reference(x, scale, bias, 32, 1e-5, "silu", add)
    _build.launches.clear()
    fused = group_norm(x, scale, bias, 32, 1e-5, "silu", add)
    launch = GroupNormLaunch(x, scale, bias, 32, 1e-5, "silu", add)
    two = launch.two_pass()
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"group_norm_fused": 1,
                                     "group_norm_stats": 1,
                                     "group_norm_apply": 1}
    assert _within(fused, ref) and _within(two, ref)
    assert torch.equal(fused, group_norm(x, scale, bias, 32, 1e-5, "silu", add))
    assert torch.equal(two.clone(), launch.two_pass())


def test_group_norm_takes_unaligned_x(cuda):
    """A contiguous x whose data does not start on 16 bytes runs the
    kernel's scalar loads."""
    x = torch.randn(2 * 64 * 16 * 16 + 1, device=cuda).bfloat16()[1:] \
        .view(2, 64, 16, 16)
    scale, bias = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    _build.launches.clear()
    out = group_norm(x, scale, bias, 32, 1e-6, "silu")
    torch.cuda.synchronize()
    assert _build.launches["group_norm_apply"] == 1
    assert _within(out, group_norm_reference(x, scale, bias, 32, 1e-6, "silu"))


def test_group_norm_rejects_non_contiguous(cuda):
    x = torch.randn((1, 32, 8, 8), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        group_norm(x, torch.ones(32, device=cuda), torch.zeros(32, device=cuda),
                   8)


def _nf4(cuda, in_f, out_f, seed=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((in_f, out_f), generator=g, device=cuda) * in_f ** -0.5
    return quantize_nf4(w.bfloat16()), g


@pytest.mark.parametrize("m", [1, 3, 17, 640])
@pytest.mark.parametrize("in_f,out_f", [(512, 288), (576, 40)])
def test_nf4_matmul_matches_plain(cuda, m, in_f, out_f):
    """Both paths of the kernel (M <= 8 and the tiled product), a ragged
    out, and in=576, whose low-nibble half starts mid-block."""
    q, g = _nf4(cuda, in_f, out_f)
    x = torch.randn((m, in_f), generator=g, device=cuda).bfloat16()
    _build.launches.clear()
    out = nf4_matmul_kernel(x, q)
    torch.cuda.synchronize()
    assert _build.launches["nf4_matmul"] == 1
    ref = nf4_matmul_reference(x, q)
    # the same bf16 weights and exact products; fp32 sums in another order
    # can move the one bf16 rounding of the output by a step
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-2 * (1 + ref.float().abs())).all())


def _one_bf16_step(out, walk):
    # both round fp32 sums of the same bf16 products once, in other orders
    big = torch.maximum(out.abs(), walk.abs()).clamp_min(2.0 ** -126)
    return bool(((out - walk).abs() <= torch.exp2(torch.floor(torch.log2(big)) - 7)).all())


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("in_f,out_f", [(64, 128), (192, 40), (512, 288), (576, 40)])
def test_nf4_decode_route_matches_plain_and_its_tile_walk(cuda, m, in_f, out_f):
    """The decode route (M <= 8): against the plain version, within one
    bf16 step of the plain walk of its schedule, the same bits on two
    calls, and one launch counted on its route."""
    q, g = _nf4(cuda, in_f, out_f, seed=m)
    x = torch.randn((m, in_f), generator=g, device=cuda).bfloat16()
    _build.launches.clear()
    out = nf4_matmul_kernel(x, q)
    again = nf4_matmul_kernel(x, q)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"nf4_matmul": 2, "nf4_gemv": 2}
    assert torch.equal(out, again)
    ref = nf4_matmul_reference(x, q)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-2 * (1 + ref.float().abs())).all())
    walk = nf4_gemv_tiled(x, q, plan_nf4_gemv(m, in_f, out_f)).float()
    assert _one_bf16_step(out.float(), walk)


@pytest.mark.parametrize("m,in_f,out_f,x_whole", [
    (8, 576, 40, True), (4, 5120, 72, True),
    (2, 13824, 40, False),               # x too large to stage whole at m = 2
    (2, 8256, 40, False)])               # and ragged rows, a partial last quad
def test_nf4_decode_route_with_x_whole_and_through_the_rings(cuda, m, in_f, out_f, x_whole):
    """Both ways of staging x, each where the plan picks it (whole at block
    start, a piece a lane a step through the rings): the plain version's
    result within tolerance, the same bits on two calls, within one bf16
    step of the plain walk of the schedule."""
    plan = plan_nf4_gemv(m, in_f, out_f)
    assert plan.x_whole == x_whole
    q, g = _nf4(cuda, in_f, out_f, seed=m)
    x = torch.randn((m, in_f), generator=g, device=cuda).bfloat16()
    out = nf4_matmul_kernel(x, q)
    assert torch.equal(out, nf4_matmul_kernel(x, q))
    ref = nf4_matmul_reference(x, q).float()
    assert bool(((out.float() - ref).abs() <= 1e-2 * (1 + ref.abs())).all())
    assert _one_bf16_step(out.float(), nf4_gemv_tiled(x, q, plan).float())


def test_nf4_decode_entry_point_holds_the_plans_shared_memory(cuda):
    """The kernel lays shared memory out by its own copy of the plan's
    formulas: it takes the plan's bytes and grid, and refuses 16 bytes
    less or another grid, in both x modes, with and without masks."""
    lib = _build.load("nf4_matmul")
    fn = lib.fd_nf4_gemv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for m, in_f, out_f in ((8, 576, 40), (2, 5120, 64), (2, 13824, 48), (3, 8256, 40)):
        p = plan_nf4_gemv(m, in_f, out_f)
        q, g = _nf4(cuda, in_f, out_f)
        x = torch.randn((m, in_f), generator=g, device=cuda).bfloat16()
        y = torch.empty((m, out_f), dtype=torch.bfloat16, device=cuda)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(grid, smem):
            return fn(x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(), y.data_ptr(),
                      m, in_f, out_f, int(p.full), int(p.x_whole), grid, smem, stream)

        assert launch(p.grid, p.smem_bytes) == 0, p
        torch.cuda.synchronize()
        assert torch.equal(y, nf4_matmul_kernel(x, q))
        assert launch(p.grid, p.smem_bytes - 16) != 0, p
        assert launch(p.grid + 1, p.smem_bytes) != 0, p
        assert launch(p.grid - 1, p.smem_bytes) != 0, p


def test_nf4_decode_kernel_keeps_its_register_cap(cuda):
    """`__launch_bounds__(256, 4)`: four blocks of 256 threads an SM leave
    each lane 65,536 / 1,024 = 64 registers; every instance of the decode
    kernel fits them with no local memory (spills)."""
    lib = _build.build_all()["nf4_matmul"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    # "Function <name>:" then, on its own line, "REG:n STACK:n SHARED:n LOCAL:n ..."
    usage = {name: dict(re.findall(r"(\w+):(\d+)", fields)) for name, fields in
             re.findall(r"Function (\S*nf4_gemv_kernel\S*):\s*([^\n]*)", dump)}
    assert len(usage) == 4, dump                 # (full, x_whole) in {0, 1}^2
    for name, use in usage.items():
        assert {"REG", "STACK", "LOCAL"} <= use.keys(), dump
        assert int(use["REG"]) <= 65536 // (4 * plan_nf4_gemv(1, 64, 16).threads), (name, use)
        assert int(use["STACK"]) == 0 and int(use["LOCAL"]) == 0, (name, use)


@pytest.mark.parametrize("m", [9, 16, 17, 640, 1244])
@pytest.mark.parametrize("in_f,out_f", [(64, 40), (64, 288), (576, 40), (576, 288),
                                        (13824, 136)])
def test_nf4_prefill_route_matches_plain_and_its_tile_walk(cuda, m, in_f, out_f):
    """The prefill route (M > 8) at ragged M, ragged out, in = 64 (half a K
    step) and 576 (the low half starting mid-block, a half-full last step):
    against the plain version, within one bf16 step of the plain walk of
    its plan, the same bits on two calls, one launch a call on its route."""
    q, g = _nf4(cuda, in_f, out_f, seed=m)
    x = torch.randn((m, in_f), generator=g, device=cuda).bfloat16()
    _build.launches.clear()
    out = nf4_matmul_kernel(x, q)
    again = nf4_matmul_kernel(x, q)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"nf4_matmul": 2, "nf4_gemm": 2}
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out).all())
    ref = nf4_matmul_reference(x, q)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-2 * (1 + ref.float().abs())).all())
    walk = nf4_gemm_tiled(x, q, plan_nf4_gemm(m, in_f, out_f)).float()
    # both sum the same bf16 products in fp32, the kernel in the wgmma's
    # order: apart by at most in_f * 2^-23 of the sum of |products| before
    # the one bf16 rounding of each (which matters where the sum cancels)
    mag = x.float().abs() @ dequantize_nf4(q, torch.bfloat16).float().abs()
    big = torch.maximum(out.float().abs(), walk.abs()).clamp_min(2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool(((out.float() - walk).abs() <= step + in_f * 2.0 ** -23 * mag).all())


def test_nf4_prefill_entry_point_holds_the_plan(cuda):
    """The kernel lays shared memory out by its own copy of the plan's
    formulas: it takes the plan's numbers and refuses 16 bytes less, more
    than a block may have, another grid, another `full`, an x tile it has
    no instance for, or a ring of one stage."""
    lib = _build.load("nf4_matmul")
    fn = lib.fd_nf4_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for m, in_f, out_f in ((1244, 576, 40), (16, 512, 256), (640, 5120, 128)):
        p = plan_nf4_gemm(m, in_f, out_f)
        q, g = _nf4(cuda, in_f, out_f)
        x = torch.randn((m, in_f), generator=g, device=cuda).bfloat16()
        y = torch.empty((m, out_f), dtype=torch.bfloat16, device=cuda)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(n_tile=p.n_tile, stages=p.stages, grid=p.grid, smem=p.smem_bytes,
                   full=p.full):
            return fn(x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(), y.data_ptr(),
                      m, in_f, out_f, n_tile, stages, grid, smem, int(full), stream)

        assert launch() == 0, p
        torch.cuda.synchronize()
        assert torch.equal(y, nf4_matmul_kernel(x, q))
        for bad in (dict(smem=p.smem_bytes - 16), dict(smem=227 * 1024),
                    dict(grid=p.grid + 1), dict(grid=p.grid - 1), dict(full=not p.full),
                    dict(n_tile=24), dict(stages=1)):
            assert launch(**bad) != 0, (p, bad)


def test_nf4_prefill_kernel_fits_its_registers(cuda):
    """One block of 384 threads an SM: at launch 65,536 / 384 -> 168
    registers a thread; every instance of the prefill kernel fits them with
    no local memory (spills), one for each x tile of the plan."""
    lib = _build.build_all()["nf4_matmul"]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    usage = {name: dict(re.findall(r"(\w+):(\d+)", fields)) for name, fields in
             re.findall(r"Function (\S*nf4_gemm_kernel\S*):\s*([^\n]*)", dump)}
    assert len(usage) == 16, dump                # n_tile in 16, 32, ..., 256
    for name, use in usage.items():
        assert {"REG", "STACK", "LOCAL"} <= use.keys(), dump
        assert int(use["REG"]) <= 168, (name, use)
        assert int(use["STACK"]) == 0 and int(use["LOCAL"]) == 0, (name, use)


def test_nf4_matmul_counts_its_route(cuda):
    q, g = _nf4(cuda, 576, 40)
    for m, route in ((1, "nf4_gemv"), (8, "nf4_gemv"), (17, "nf4_gemm")):
        x = torch.randn((m, 576), generator=g, device=cuda).bfloat16()
        _build.launches.clear()
        nf4_matmul_kernel(x, q)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {"nf4_matmul": 1, route: 1}


def test_nf4_matmul_rejects_what_it_does_not_take(cuda):
    q, _ = _nf4(cuda, 512, 64)
    x = torch.randn((2, 512), device=cuda).bfloat16()
    with pytest.raises(ValueError):
        nf4_matmul_kernel(x, q._replace(pack_format=NF4_PACK_PAIRWISE))
    with pytest.raises(TypeError):
        nf4_matmul_kernel(x.float(), q)
    odd = NF4Weight(torch.zeros((64, 48), dtype=torch.uint8, device=cuda),
                    torch.ones((64, 1), device=cuda), (96, 64))
    with pytest.raises(ValueError):
        nf4_matmul_kernel(torch.zeros((2, 96), device=cuda).bfloat16(), odd)
    with pytest.raises(ValueError):
        nf4_matmul_kernel(torch.randn((512, 2), device=cuda).bfloat16().T, q)


def test_nf4_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    q, g = _nf4(cuda, 512, 96)
    x = torch.randn((2, 3, 512), generator=g, device=cuda).bfloat16()
    _build.launches.clear()
    out = nf4_matmul(x, q)
    torch.cuda.synchronize()
    assert _build.launches["nf4_matmul"] == 1
    assert out.shape == (2, 3, 96) and out.dtype == torch.bfloat16


def test_chunked_restore_matches_unchunked(cuda):
    """A tiny restore of 5 tiles (64x192 px at tile_size 64) on the card,
    fp32 (GroupNorm's kernel at fp32; TF32 off so that both runs sum in
    fp32), in chunks of 2 tiles against one UNet call a step: latents
    within 2^-8 * max|ref|, no call above 4 rows, the kernel launched."""
    from faithdiff_tpu_torch.config import PipelineConfig
    from faithdiff_tpu_torch.pipelines import build_tiny_pipeline

    pipe = build_tiny_pipeline(
        pipeline_config=PipelineConfig(tile_size=64, num_inference_steps=3),
        device=cuda, seed=1)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (64, 192, 3), dtype=np.uint8)
    pe = rng.standard_normal((1, 77, 64)).astype(np.float32)
    pooled = rng.standard_normal((1, 64)).astype(np.float32)
    rows = []
    hook = pipe.unet.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[0]))
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = pipe(img, pe, pooled, seed=3, output_type="latent")
        pipe.tile_chunk = 2
        rows.clear()
        _build.launches.clear()
        got = pipe(img, pe, pooled, seed=3, output_type="latent")
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = before
        hook.remove()
    assert rows == [4, 4, 2] * 3
    assert sum(v for k, v in _build.launches.items() if k.startswith("group_norm")) > 0
    err = float((got - ref).abs().max())
    assert err <= 2 ** -8 * float(ref.abs().max()), err


def test_text_towers_bf16_on_the_card_match_fp32_on_the_cpu(cuda):
    """Both tiny towers at SDXL's vocabulary (49408, EOS 49407), bf16 on
    the card against the same weights in fp32 on the CPU, within
    5e-2 * (1 + |ref|)."""
    from faithdiff_tpu_torch.config import tiny_text_encoder_configs
    from faithdiff_tpu_torch.models.clip_text import SDXLTextEncoder
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    c1, c2 = (dataclasses.replace(c, vocab_size=49408)
              for c in tiny_text_encoder_configs())
    with cuda:
        enc = SDXLTextEncoder(c1, c2, dtype=torch.bfloat16).eval()
    random_init_(enc, torch.Generator(device=cuda).manual_seed(4))
    ref_enc = SDXLTextEncoder(c1, c2).eval()
    ref_enc.load_state_dict({k: v.float().cpu() for k, v in enc.state_dict().items()})
    ids = torch.full((3, 77), 49407)
    ids[:, 0] = 49406
    ids[0, 1:6] = torch.arange(100, 105)
    ids[2, 1:76] = torch.arange(1000, 1075)
    with torch.no_grad():
        got, want = enc(ids, ids), ref_enc(ids, ids)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.bfloat16
        err = (g.float().cpu() - w).abs()
        assert bool((err <= 5e-2 * (1 + w.abs())).all()), float(err.max())


def test_int8_captioner_on_the_card_matches_the_cpu(cuda):
    """A tiny int8 LLaMA (the caption CLI's default quantisation), bf16 on
    the card against the same weights in fp32 on the CPU: prefill logits
    and one-row logits within 5e-2 * (1 + |ref|), the tolerance of the
    tiny nf4 captioner's check in `chip_smoke.py`; no NF4 launch."""
    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig,
                                                     LlamaForCausalLM,
                                                     random_init_quantized_)
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig.tiny(), quant="int8")
    cpu = LlamaForCausalLM(cfg).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(3)
    random_init_(cpu, gen)
    random_init_quantized_(cpu, gen)
    with cuda:
        card = LlamaForCausalLM(cfg, dtype=torch.bfloat16).eval().requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    emb = torch.randn((2, 12, cfg.hidden_size), generator=gen)
    pos = torch.arange(12)[None].expand(2, 12)
    _build.launches.clear()
    with torch.no_grad():
        for e, p in ((emb, pos), (emb[:1, :1], pos[:1, :1])):
            ref, _ = cpu(e, p)
            got, _ = card(e.to(cuda).bfloat16(), p.to(cuda))
            assert got.dtype == torch.bfloat16
            err = (got.float().cpu() - ref).abs()
            assert bool((err <= 5e-2 * (1 + ref.abs())).all()), float(err.max())
    torch.cuda.synchronize()
    assert not _build.launches.get("nf4_matmul")


@pytest.mark.parametrize("kind", ["flash", "flash_causal", "packed",
                                  "group_norm_fused", "group_norm_two_pass"])
def test_autograd_functions_match_plain_on_card(cuda, kind):
    """Each entry point under autograd on the card: one kernel launch in the
    forward, bitwise the bare kernel's output and within 1e-2 + 8e-3*|ref|
    of the plain version, none in the backward, and every gradient equal
    in every bit to autograd over the plain version (which is what the
    Function's backward runs, on the same inputs with autocast off)."""
    from faithdiff_tpu_torch.ops import attention as A
    from faithdiff_tpu_torch.ops import groupnorm as G

    g = torch.Generator(device=cuda).manual_seed(1)

    def leaf(shape, dtype=torch.bfloat16, offset=0.0):
        return (torch.randn(shape, generator=g, device=cuda) + offset).to(
            dtype).requires_grad_(True)

    if kind.startswith("flash"):
        causal = kind == "flash_causal"
        inputs = [leaf((2, 3, 1024, 64)) for _ in range(3)]
        entry = lambda q, k, v: A.flash_attention(q, k, v, 0.125, causal)  # noqa: E731
        bare = lambda q, k, v: A._flash_attention_launch(q, k, v, 0.125, causal)  # noqa: E731
        plain = lambda q, k, v: A.attention_reference(q, k, v, 0.125, causal)  # noqa: E731
        counters = ("flash_attention_fwd",)
    elif kind == "packed":
        inputs = [leaf((2, 1024, 256)) for _ in range(3)]
        entry = lambda q, k, v: A.flash_attention_packed(q, k, v, 4, 0.125)  # noqa: E731
        bare = lambda q, k, v: A._flash_packed_launch(q, k, v, 4, 0.125)  # noqa: E731
        plain = lambda q, k, v: A.einsum_bsnd(q, k, v, 4, 0.125)  # noqa: E731
        counters = ("flash_attention_bsnd_fwd",)
    else:
        # the denoise encoder's first norm at 512 px outgrows a cluster
        shape = (2, 64, 16, 16) if kind == "group_norm_fused" else (1, 128, 512, 512)
        plan = G.plan_group_norm(shape, 2, 32)
        assert plan.route == kind[len("group_norm_"):]
        c = shape[1]
        inputs = [leaf(shape, offset=0.5), leaf(c, torch.float32, 1.0),
                  leaf(c, torch.float32), leaf(shape[:2])]
        entry = lambda x, s, b, a: G.group_norm(x, s, b, 32, 1e-6, "silu", a)  # noqa: E731
        bare = lambda x, s, b, a: G.GroupNormLaunch(x, s, b, 32, 1e-6, "silu", a).run()  # noqa: E731
        plain = lambda x, s, b, a: G.group_norm_reference(x, s, b, 32, 1e-6, "silu", a)  # noqa: E731
        counters = plan.counters
    _build.launches.clear()
    out = entry(*inputs)
    torch.cuda.synchronize()
    assert {c: _build.launches[c] for c in counters} == {c: 1 for c in counters}
    with torch.no_grad():
        assert torch.equal(out, bare(*inputs))
    cot = torch.randn(out.shape, generator=g, device=cuda).to(out.dtype)
    _build.launches.clear()
    grads = torch.autograd.grad(out, inputs, cot)
    torch.cuda.synchronize()
    assert sum(_build.launches.values()) == 0
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    plain_out = plain(*leaves)
    ref = plain_out.detach().float()
    err = (out.detach().float() - ref).abs()
    assert bool((err <= 1e-2 + 8e-3 * ref.abs()).all()), float(err.max())
    refs = torch.autograd.grad(plain_out, leaves, cot)
    for got, ref in zip(grads, refs):
        assert torch.equal(got, ref), (got.float() - ref.float()).abs().max()


def _relative_l2(got, ref) -> float:
    return float((got.float().cpu() - ref).norm() / max(float(ref.norm()), 1e-12))


def test_tiny_train_step_on_card_matches_cpu(cuda):
    """One stage-2 micro-step of the tiny configs (grad_accum 2, so the
    gradient stays in `.grad`), bf16 under autocast on the card against
    fp32 on the CPU, same weights, batch and draws: loss within 2e-2 and
    grad_norm within 5e-2 relative; the gradients within the bf16
    tolerance that the same step in bf16 on the CPU sets: each tensor's
    relative L2 error at most twice the CPU bf16 step's, + 0.05, and the
    whole gradient's at most twice, + 0.02 (bf16 gradients of a random
    tiny model are 18% off fp32 in L2 on the CPU, up to 33% for a tensor);
    the GroupNorm kernels ran."""
    from faithdiff_tpu_torch import config as C
    from faithdiff_tpu_torch.models.unet import UNet2DConditionModel
    from faithdiff_tpu_torch.models.vae import AutoencoderKL, DenoiseEncoder
    from faithdiff_tpu_torch.pipelines.factory import random_init_
    from faithdiff_tpu_torch.training.train import (draw_noise,
                                                    init_train_state,
                                                    make_train_step)

    def build(device, dtype=None):
        models = (UNet2DConditionModel(C.tiny_unet_config()),
                  DenoiseEncoder(C.tiny_denoise_encoder_config()),
                  AutoencoderKL(C.tiny_vae_config()))
        gen = torch.Generator().manual_seed(0)
        for m in models:
            random_init_(m, gen)
            m.to(device)
        models[2].requires_grad_(False)
        cfg = C.TrainConfig(stage=2, grad_accum=2, lr_warmup_steps=0)
        state = init_train_state(cfg, models[0], models[1])
        dtype = dtype or (torch.float32 if device == "cpu" else torch.bfloat16)
        return state, make_train_step(*models, cfg, compute_dtype=dtype)

    r = np.random.default_rng(0)
    batch = {"hr": r.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32),
             "lq": r.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32),
             "prompt_embeds": r.standard_normal((2, 77, 64)).astype(np.float32),
             "pooled_embeds": r.standard_normal((2, 64)).astype(np.float32),
             "add_time_ids": np.zeros((2, 6), np.float32)}
    draws = draw_noise(2, (2, 4, 8, 8), 1000, torch.Generator().manual_seed(1),
                       "cpu")
    cpu_state, cpu_step = build("cpu")
    ref = cpu_step(cpu_state, batch, draws=draws)
    bf16_state, bf16_step = build("cpu", torch.bfloat16)
    bf16_step(bf16_state, batch, draws=draws)
    card_state, card_step = build("cuda")
    _build.launches.clear()
    got = card_step(card_state, batch,
                    draws={k: (v if k == "t" else v.to(cuda))
                           for k, v in draws.items()})
    torch.cuda.synchronize()
    assert _build.launches["group_norm_fused"] > 0
    assert abs(float(got["loss"]) - float(ref["loss"])) <= 2e-2 * float(ref["loss"])
    assert abs(float(got["grad_norm"]) - float(ref["grad_norm"])) <= \
        5e-2 * float(ref["grad_norm"])
    refs = {n: p.grad for n, p in cpu_state.trainable().items()}
    card = {n: p.grad for n, p in card_state.trainable().items()}
    bf16 = {n: p.grad for n, p in bf16_state.trainable().items()}
    flat = [torch.cat([d[n].float().cpu().flatten() for n in refs])
            for d in (card, bf16, refs)]
    assert _relative_l2(flat[0], flat[2]) <= \
        2 * _relative_l2(flat[1], flat[2]) + 0.02
    for name, ref_grad in refs.items():
        err = _relative_l2(card[name], ref_grad)
        assert err <= 2 * _relative_l2(bf16[name], ref_grad) + 0.05, (name, err)
