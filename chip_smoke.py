#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`faithdiff_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit.
2. Builds the port's CUDA kernels from `faithdiff_tpu_torch/csrc/` (one
   `nvcc` per source, all started together).
3. Holds the flash-attention kernels (BHSD at d=64 and d=128, packed), the
   attention-variant kernel and the GroupNorm kernels against their plain
   PyTorch versions on the card, in bf16 at their paths' shapes, and times
   kernel, plain version, a PyTorch library call that computes the same
   function (a yardstick only) and the card's bound for the same work.
   The flash rows' kernel and library times come from CUDA graphs, with
   the achieved TFLOP/s, the time over the bound and the wrapper's host
   cost beside them. Also holds the flash kernels at ragged and short
   lengths and on column-slice operands (correctness only).
3b. GroupNorm, both routes of `ops/groupnorm.plan_group_norm` at the UNet's
   ResNet / Transformer2D shapes at batch 4, the full-resolution VAE shape
   and the 15-tile restore's [30, 2560, 32, 32] (B*C = 76,800 rows): the
   single-pass cluster kernel where the plan has one (output against the
   plain version and against `group_norm_tiled`, statistics read from an
   fp32 run, same bits on a repeat) and the two-pass pair through the
   launch's own methods. Every GroupNorm time comes from CUDA graphs, each
   row with its bound, `F.group_norm` where that one call computes the same
   function, and the wrapper's host cost (`host_us`).
4. Runs a full-width restore (default SDXL UNet / VAE / denoise-encoder
   configs, bf16, seeded random weights) of a 1024x1536 uint8 image: two
   128^2 latent tiles, 20 Euler steps, guidance 5, start_point "lr",
   wavelet color fix. Checks the output and that every kernel of the path
   was launched the expected number of times: the flash kernel once per
   self-attention, and each GroupNorm's kernels as the launch plan predicts
   from the shape each GroupNorm module saw (forward hooks).
5. Runs the restore's last UNet call once more under torch.profiler and
   prints device time by layer and by kernel, and the busy share.
5b. Runs the same restore again on the packed-attention path
   (`transformer2d._BSND_ATTN`, as FAITHDIFF_BSND_ATTN=1 sets it), checks
   it and its launches, profiles its last UNet call, and holds that call
   on the packed path against the default path.
5b'. `restore_large`: the same pipeline on a 2048x3072 uint8 image (a
   1024x1536 photo at the CLI's default --upscale 2): 15 latent tiles, UNet
   batch 30, 20 steps, the default attention path; checks the output
   shape, finite latents, 20 UNet calls and the planned GroupNorm launches,
   and prints wall, denoise and decode seconds, the UNet call medians,
   peak memory and the launches. Then frees the pipeline.
5c. Runs the attention-variant benchmark's entry point
   (`faithdiff_tpu_torch.scripts.bench_attention_variants.main`) and
   checks its launches.
6. Holds the NF4 dequant-matmul kernel against its
   plain version at the 13B captioner's shapes (M = 1, 2, 640 and the
   caption's own prefill M, 2 x the prompt length), with its
   bound and, as context only, a bf16 matmul against the decoded weight.
7. Holds a tiny nf4 captioner LLaMA on the card (kernel) against the same
   weights on the CPU (plain version, fp32), and runs the causal prefill
   of the full-width 13B LLaMA's first two layers over 1024 tokens, which
   goes through the flash kernel at head dim 128.
8. Captions two images with the full-width LLaVA-1.5-13B captioner
   (`quant="nf4"`, ViT-L/14-336, mlp2x projector; bf16, seeded random
   weights; the agent's defaults: temperature 0.2, top-p 0.7, 512 new
   tokens) and checks the prompt, the tokens, finite logits and that the
   NF4 kernel ran 280 times (7 projections x 40 layers) per forward pass;
   then profiles the last decode step as step 5 profiles the UNet.
9. Prints the card line, a JSON line listing every ported kernel, then a
   last JSON line `{"ok": true, "device": {...}}`, only when every phase
   passed.

Imports nothing of JAX. Exits nonzero on any failure.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth

# (shape [B, H, S, D], causal): the UNet self-attentions at a 1024^2 tile
# (2 tiles x CFG pair = batch 4), the causal square case, the 13B LLaMA's
# causal prefill over 1024 tokens (a batch of two) and a non-causal d=128
# case at the largest K/V the JAX gate sends to its kernel (4096 x 128)
ATTN_SHAPES = [((4, 10, 4096, 64), False), ((4, 20, 1024, 64), False),
               ((1, 20, 1024, 64), True), ((2, 40, 1024, 128), True),
               ((1, 40, 4096, 128), False)]
# ([b, s, n*d], heads): the UNet self-attentions on the packed path
PACKED_SHAPES = [((4, 4096, 640), 10), ((4, 1024, 1280), 20)]
# (shape, base2, block_k) of the variant kernel's kernels entry
VARIANT_REPORT = ((20, 4096, 64), True, 64)
# (shape NCHW, eps, act, with add): UNet ResNet / Transformer2D norms, the
# full-resolution VAE decoder norm (two-pass: its group outgrows a cluster)
# and the 15-tile restore's largest ResNet norm (B*C = 76,800 rows)
GN_SHAPES = [((4, 320, 128, 128), 1e-5, "silu", True),
             ((4, 640, 64, 64), 1e-6, None, False),
             ((4, 1280, 32, 32), 1e-5, "silu", True),
             ((1, 128, 1024, 1536), 1e-6, "silu", False),
             ((30, 2560, 32, 32), 1e-5, "silu", True)]
# the shape each kernel's JSON entry reports: the first attention shape,
# and the GroupNorm shape for which one library call (F.group_norm)
# computes the same function
ATTN_REPORT, GN_REPORT, PACKED_REPORT = 0, 1, 0

TILE_PIXELS = (1024, 1536)
# a 1024x1536 photo at the CLI's default --upscale 2: 15 latent tiles of
# 128^2, UNet batch 30 (B*C up to 76,800 rows in its ResNet norms)
LARGE_PIXELS, LARGE_TILES = (2048, 3072), 15
STEPS = 20

# the 13B LLaMA projections (in, out): q/k/v/o, gate/up, down; M = B at
# decode and B * prompt length at prefill. check_nf4 adds the caption's
# own prefill M (caption_prefill_m), whose last 64-row tile is partial.
NF4_SHAPES = [(5120, 5120), (5120, 13824), (13824, 5120)]
NF4_M = [1, 2, 640]
NF4_REPORT = (1, 5120, 13824)            # (M, in, out) of the kernels entry
CAPTION_IMAGES = [(768, 1024), (1024, 768)]
CAPTION_NEW_TOKENS = 512
NF4_PER_FORWARD = 7 * 40                 # projections x layers of the 13B LLaMA
PREFILL_LAYERS, PREFILL_TOKENS = 2, 1024
# the packed and the default path run the self-attentions through the same
# tile arithmetic, and on an H100 they gave the same bits (max error 0);
# one bf16 step of the largest output leaves room only for a library call
# that sums the cross-attention's products in another order
PARITY_TOL = 2 ** -8                     # x max|default path's output|


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around `iters`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device time of one call of `fn`, from CUDA events around
    replays of a CUDA graph holding `launches` calls: the host's launch
    rate, which a loop of Python wrapper calls measures at a few tens of
    microseconds a call, drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    return time_ms(torch, graph.replay, replays, warmup=1) / launches


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call of `fn`, in microseconds: the wall time of a
    loop of calls short enough not to fill the launch queue, over its
    length."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def flash_timing(torch, flops, nbytes, kernel, plain, library) -> dict:
    """The timing keys of a flash row: kernel and library call from CUDA
    graphs (device time; at under ~0.2 ms a loop of wrapper calls measures
    the host), the plain version from a loop of calls, the bound, and the
    wrapper's host cost."""
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = graph_ms(torch, kernel)
    return dict(ms=ms, plain_ms=time_ms(torch, plain, 3, 1),
                library_ms=graph_ms(torch, library), bound_ms=b_ms,
                bound_by=b_by, tflops=flops / ms / 1e9, ms_over_bound=ms / b_ms,
                wrapper_host_us=host_us(torch, kernel))


def entry_host_us(torch, q, k, v, scale: float, causal: bool) -> float:
    """Host time of the flash kernel's C entry point alone (four tensor-map
    encodes and the launch), without the Python wrapper around it. The
    wrapper has been called before, so the function's argtypes are set."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops import attention as A

    out = torch.empty_like(q)
    fn = _build.load("flash_attention").fd_flash_attention_fwd
    geometry = A._geometry_argument((
        A.bhsd_geometry(q.shape, A.GROUP_ROWS), A.bhsd_geometry(k.shape, A.BLOCK_K),
        A.bhsd_geometry(v.shape, A.BLOCK_K), A.bhsd_geometry(out.shape, A.GROUP_ROWS)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
            q.shape[-1], scale * A.LOG2E, int(causal),
            torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args):
            fail("fd_flash_attention_fwd returned an error")

    return host_us(torch, call)


def print_ptxas(source: str, log: str) -> None:
    """One line per compiled kernel from `nvcc -Xptxas -v`: its mangled
    name, registers and spills."""
    kernel, spill = "?", ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            print(f"  ptxas {source}: {kernel}: {line.split(':', 1)[-1].strip()}; "
                  f"{spill}", flush=True)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(ms, "operations" | "bytes"): the least time the card needs."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_attention(torch):
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                                   flash_attention)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, causal in ATTN_SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = flash_attention(q, k, v, scale, causal)
        torch.cuda.synchronize()
        ref = attention_reference(q, k, v, scale, causal)
        err = (out.float() - ref.float()).abs()
        # q is rounded to bf16 after the scale fold and p before p.v, at
        # other points than in the plain version: allow a few bf16 steps
        tol = 1e-2 + 8e-3 * ref.float().abs()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
        pairs = s * (s + 1) / 2 if causal else s * s
        row = dict(
            shape=list(shape), causal=causal, max_abs_err=float(err.max()),
            tol="1e-2 + 8e-3*|ref|", ok=ok,
            **flash_timing(
                torch, 4 * b * h * d * pairs, 4 * b * h * s * d * 2,
                lambda: flash_attention(q, k, v, scale, causal),
                lambda: attention_reference(q, k, v, scale, causal),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale)),
            entry_host_us=entry_host_us(torch, q, k, v, scale, causal))
        print("attention", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, ref, err, tol
        torch.cuda.empty_cache()
    return rows


def check_attention_packed(torch):
    """The packed-layout kernel against `einsum_bsnd` at the UNet's packed
    shapes; SDPA on the same data seen as [b, n, s, d] views is the
    yardstick."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention import (einsum_bsnd,
                                                   flash_attention_packed)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, heads in PACKED_SHAPES:
        b, s, f = shape
        d = f // heads
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = flash_attention_packed(q, k, v, heads, scale)
        torch.cuda.synchronize()
        ref = einsum_bsnd(q, k, v, heads, scale)
        err = (out.float() - ref.float()).abs()
        # as for the BHSD kernel: q and p are rounded to bf16 at other points
        tol = 1e-2 + 8e-3 * ref.float().abs()
        ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
        qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
        row = dict(
            shape=list(shape), heads=heads, max_abs_err=float(err.max()),
            tol="1e-2 + 8e-3*|ref|", ok=ok,
            **flash_timing(
                torch, 4 * b * heads * d * s * s, 4 * b * s * f * 2,
                lambda: flash_attention_packed(q, k, v, heads, scale),
                lambda: einsum_bsnd(q, k, v, heads, scale),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)))
        print("attention_packed", json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, qh, kh, vh, out, ref, err, tol
        torch.cuda.empty_cache()
    return rows


def check_attention_ragged(torch):
    """Correctness only: the flash kernels where tiles are partial. q and
    kv lengths that are no multiple of the 128-row block or the 128-row
    K/V tile, non-causal and causal, at both head dims; 70,000 planes of a
    few rows; packed operands that are column slices of fused projections,
    with a 77-row K/V; q shorter than one 64-row group; and the BHSD kernel
    against the plain walk of its own tile schedule
    (`flash_attention_tiled`)."""
    from faithdiff_tpu_torch.ops.attention import (attention_reference,
                                                   einsum_bsnd,
                                                   flash_attention,
                                                   flash_attention_packed,
                                                   flash_attention_tiled)

    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    rows = []

    def hold(what, out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        # as for the full tiles: q and p are rounded to bf16 at other points
        ok = (bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())
              and bool(torch.isfinite(out).all()))
        row = dict(case=what, max_abs_err=float(err.max()),
                   tol="1e-2 + 8e-3*|ref|", ok=ok)
        print("attention_ragged", json.dumps(row), flush=True)
        rows.append(row)

    # more planes than a grid's y extent holds: work items are dealt from
    # one linear index
    q, k, v = randn(1, 70000, 8, 64), randn(1, 70000, 16, 64), randn(1, 70000, 16, 64)
    hold("bhsd [1, 70000, 8, 16, 64] causal=False",
         flash_attention(q, k, v, 0.125), attention_reference(q, k, v, 0.125))
    for d in (64, 128):
        scale = d ** -0.5
        for (b, h, sq, skv), causal in (((2, 3, 1000, 1100), False),
                                        ((1, 3, 1030, 1030), True)):
            q, k, v = randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d)
            out = flash_attention(q, k, v, scale, causal)
            hold(f"bhsd {[b, h, sq, skv, d]} causal={causal}", out,
                 attention_reference(q, k, v, scale, causal))
            if causal:
                hold(f"bhsd {[b, h, sq, skv, d]} causal against its tile walk",
                     out, flash_attention_tiled(q, k, v, scale, True))
        # q a column slice of a fused [b, s, 3f] projection, k and v of a
        # [b, 77, 2f] one; then q shorter than one group of rows
        heads = 2
        f = heads * d
        for sq, skv in ((1030, 77), (50, 1100)):
            q = randn(2, sq, 3 * f)[..., f:2 * f]
            k, v = randn(2, skv, 2 * f).split(f, dim=-1)
            out = flash_attention_packed(q, k, v, heads, scale)
            if not out.is_contiguous():
                fail("packed output is not contiguous")
            hold(f"packed column slices {[2, sq, skv, f]} heads={heads}", out,
                 einsum_bsnd(q.contiguous(), k.contiguous(), v.contiguous(),
                             heads, scale))
    return rows


def check_attention_variants(torch):
    """Every instantiated variant against `attention_variant_reference` at
    every shape of the benchmark; SDPA on the same data is the yardstick."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.attention_variants import (
        VARIANTS, attention_variant, attention_variant_reference)
    from faithdiff_tpu_torch.scripts.bench_attention_variants import SHAPES

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for bh, s, d in SHAPES:
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        for base2, bk in VARIANTS:
            out = attention_variant(q, k, v, scale, base2, bk)
            torch.cuda.synchronize()
            ref = attention_variant_reference(q, k, v, scale, base2)
            err = (out.float() - ref.float()).abs()
            # online against one-pass softmax: p is rounded to bf16 against
            # another running max
            tol = 1e-2 + 8e-3 * ref.float().abs()
            ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
            row = dict(
                shape=[bh, s, d], base2=base2, block_k=bk,
                max_abs_err=float(err.max()), tol="1e-2 + 8e-3*|ref|", ok=ok,
                **flash_timing(
                    torch, 4 * bh * d * s * s, 4 * bh * s * d * 2,
                    lambda: attention_variant(q, k, v, scale, base2, bk),
                    lambda: attention_variant_reference(q, k, v, scale, base2),
                    lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], scale=scale)))
            print("attention_variant", json.dumps(row), flush=True)
            rows.append(row)
            del out, ref, err, tol
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def implied_stats(torch, x, y, groups, add=None):
    """Per-group mean and E[v^2] (float64) that an output y = (v - mean) *
    rstd (scale 1, bias 0, no act) implies, v = x + add: rstd by least
    squares of y on v. The single-pass kernel keeps its sums on chip; this
    is how its statistics are read."""
    b, c = x.shape[:2]
    v = x.double().reshape(b, c, -1)
    if add is not None:
        v = v + add.double().reshape(b, c, 1)
    v, y = v.reshape(b, groups, -1), y.double().reshape(b, groups, -1)
    vc, yc = v - v.mean(-1, keepdim=True), y - y.mean(-1, keepdim=True)
    rstd = (vc * yc).sum(-1) / vc.square().sum(-1)
    return v.mean(-1) - y.mean(-1) / rstd, v.square().mean(-1)


def check_group_norm(torch):
    """Both routes at every GN_SHAPES shape, bf16: the single-pass kernel
    where the plan has one (output against the plain version and the tile
    walk, statistics from an fp32 run), and the two-pass pair (partials
    against the plain statistics, output against the plain version). Every
    time from CUDA graphs; the wrapper's host cost from a loop of calls."""
    import torch.nn.functional as F

    from faithdiff_tpu_torch.ops.groupnorm import (GroupNormLaunch,
                                                   group_apply_reference,
                                                   group_norm,
                                                   group_norm_reference,
                                                   group_norm_tiled,
                                                   group_stats_reference)

    fused_rows, stats_rows, apply_rows = [], [], []
    gen = torch.Generator(device="cuda").manual_seed(1)
    groups = 32
    for shape, eps, act, with_add in GN_SHAPES:
        b, c = shape[:2]
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
        add = (torch.randn((b, c), generator=gen, device="cuda")
               if with_add else None)
        n = x[0, 0].numel() * (c // groups)
        gs1, gs2 = group_stats_reference(x, groups, add)
        ref = group_norm_reference(x, scale, bias, groups, eps, act, add)
        numel, esize = x.numel(), x.element_size()
        add_bytes = 0 if add is None else add.numel() * 4
        flops = numel * (5 + (4 if act == "silu" else 0))
        # the function's floor: x read once, y written once
        fn_ms, fn_by = bound(flops, 2 * numel * esize + add_bytes,
                             PEAK_FP32_FLOPS)
        lib_ms = None
        if add is None and act is None:
            lib_ms = graph_ms(torch, lambda: F.group_norm(
                x, groups, scale.to(x.dtype), bias.to(x.dtype), eps))
        common = dict(shape=list(shape), eps=eps, act=act, add=with_add)

        def hold(y):
            err = (y.float() - ref.float()).abs()
            # one bf16 rounding step of the output, plus fp32 noise
            ok = (bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())
                  and bool(torch.isfinite(y).all()))
            return float(err.max()), ok

        launch = GroupNormLaunch(x, scale, bias, groups, eps, act, add)
        plan = launch.plan
        if plan.cluster:
            y = launch.fused()
            torch.cuda.synchronize()
            err, ok = hold(y)
            again = launch.fused().clone()
            same = bool(torch.equal(again, launch.fused()))
            tiled = group_norm_tiled(x, scale, bias, groups, eps, act, add,
                                     route="fused")
            t_err = (y.float() - tiled.float()).abs()
            tiled_err = float(t_err.max())
            # the walk sums in another order: a bf16 step of the output
            tiled_ok = bool((t_err <= 1e-2 + 8e-3 * tiled.float().abs()).all())
            x32 = x.float()
            y32 = GroupNormLaunch(x32, torch.ones_like(scale),
                                  torch.zeros_like(bias), groups, eps, None,
                                  add).fused()
            mean, m2 = implied_stats(torch, x32, y32, groups, add)
            s_err = float(torch.maximum((mean - gs1.double() / n).abs(),
                                        (m2 - gs2.double() / n).abs()).max())
            ms = graph_ms(torch, launch.fused)
            row = dict(common, route="fused", cluster=plan.cluster,
                       slice_kib=plan.slice_len * esize / 1024,
                       blocks=plan.fused_grid, max_abs_err=err,
                       tol="1e-2 + 8e-3*|ref|", stats_err=s_err,
                       stats_tol="1e-4", tiled_err=tiled_err, same_bits=same,
                       ok=ok and same and s_err <= 1e-4 and tiled_ok,
                       ms=ms, plain_ms=time_ms(torch, lambda: group_norm_reference(
                           x, scale, bias, groups, eps, act, add), 3, 1),
                       library_ms=lib_ms, bound_ms=fn_ms, bound_by=fn_by,
                       ms_over_bound=ms / fn_ms,
                       host_us=host_us(torch, lambda: group_norm(
                           x, scale, bias, groups, eps, act, add)))
            print("group_norm_fused", json.dumps(row), flush=True)
            fused_rows.append(row)
            del y, y32, x32, tiled, t_err, again
        # the two-pass pair, through the launch's own methods
        partial = launch.stats()
        y = launch.apply()
        torch.cuda.synchronize()
        folded = partial.double().sum(dim=1).reshape(b, groups, 2)
        # pass 1: mean and E[x^2] per group, fp32 sums in another order
        s_err = torch.maximum((folded[..., 0] / n - gs1.double() / n).abs(),
                              (folded[..., 1] / n - gs2.double() / n).abs())
        err, a_ok = hold(y)
        same = bool(torch.equal(y.clone(), launch.two_pass()))
        pair_ms = graph_ms(torch, launch.two_pass)
        st_ms, st_by = bound(numel * 4, numel * esize + add_bytes,
                             PEAK_FP32_FLOPS)
        ap_ms, ap_by = bound(numel * (3 + (4 if act == "silu" else 0)),
                             2 * numel * esize + add_bytes, PEAK_FP32_FLOPS)
        two = dict(route="two_pass", pair_ms=pair_ms,
                   pair_over_bound=pair_ms / fn_ms, function_bound_ms=fn_ms,
                   host_us=(None if plan.route == "fused" else host_us(
                       torch, lambda: group_norm(x, scale, bias, groups, eps,
                                                 act, add))))
        srow = dict(common, **two, max_abs_err=float(s_err.max()), tol="1e-4",
                    ok=bool((s_err <= 1e-4).all()),
                    ms=graph_ms(torch, launch.stats),
                    plain_ms=time_ms(torch, lambda: group_stats_reference(
                        x, groups, add), 3, 1),
                    library_ms=None, bound_ms=st_ms, bound_by=st_by)
        arow = dict(common, **two, max_abs_err=err, tol="1e-2 + 8e-3*|ref|",
                    same_bits=same, ok=a_ok and same,
                    ms=graph_ms(torch, launch.apply),
                    plain_ms=time_ms(torch, lambda: group_apply_reference(
                        x, gs1, gs2, scale, bias, groups, eps, act, add), 3, 1),
                    library_ms=lib_ms, bound_ms=ap_ms, bound_by=ap_by)
        print("group_norm_stats", json.dumps(srow), flush=True)
        print("group_norm_apply", json.dumps(arow), flush=True)
        stats_rows.append(srow)
        apply_rows.append(arow)
        del x, y, ref, launch, partial
        torch.cuda.empty_cache()
    return fused_rows, stats_rows, apply_rows


def count_modules(module, cls) -> int:
    return sum(isinstance(m, cls) for m in module.modules())


@contextlib.contextmanager
def attention_path(packed: bool):
    """Within the block, the UNet's Attention modules take the packed path
    (`transformer2d._BSND_ATTN`, which FAITHDIFF_BSND_ATTN=1 sets at
    import) when `packed`, the default path otherwise."""
    from faithdiff_tpu_torch.models import transformer2d

    before = transformer2d._BSND_ATTN
    transformer2d._BSND_ATTN = packed
    try:
        yield
    finally:
        transformer2d._BSND_ATTN = before


def build_restore(torch):
    """build_pipeline() at full width."""
    from faithdiff_tpu_torch.pipelines import build_pipeline

    t0 = time.perf_counter()
    pipe = build_pipeline(device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.denoise_encoder)
                   for p in m.parameters())
    print(f"restore: built pipeline in {build_s:.1f} s, {n_params / 1e9:.3f} B params",
          flush=True)
    return pipe


def run_restore(torch, pipe, packed: bool, pixels=TILE_PIXELS,
                label: str = ""):
    """The main path: one restore of a `pixels` uint8 image, on the default
    attention path or on the packed one. Checks the output, the UNet calls
    and that every kernel ran as often as expected: the flash kernel once
    per self-attention a UNet call, and each GroupNorm's kernels as the
    launch plan predicts from the shape the module saw. Returns the launch
    counts and the last UNet call's (args, kwargs)."""
    import numpy as np

    from faithdiff_tpu_torch.models.layers import GroupNorm
    from faithdiff_tpu_torch.models.transformer2d import BasicTransformerBlock
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.groupnorm import plan_group_norm

    label = label or ("restore_packed" if packed else "restore")
    # every self-attention (attn1) of the UNet runs at >= 1024 tokens at a
    # 128^2 latent tile and so goes to a flash kernel: the BHSD one by
    # default, the packed one on the packed path
    gn_unet = count_modules(pipe.unet, GroupNorm)
    attn_unet = count_modules(pipe.unet, BasicTransformerBlock)
    if (gn_unet, attn_unet) != (47, 70):
        fail(f"UNet has {gn_unet} GroupNorms and {attn_unet} self-attentions, "
             "expected 47 and 70")

    unet_ms = []
    events = []
    last_call = []
    # (model, shape, itemsize, groups, aligned) of each GroupNorm call
    gn_seen = []

    def pre_hook(module, args, kwargs):
        last_call[:] = [args, kwargs]
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    def post_hook(module, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    def gn_hook(model):
        def hook(module, args):
            x = args[0]
            gn_seen.append((model, tuple(x.shape), x.element_size(),
                            module.num_groups, x.data_ptr() % 16 == 0))
        return hook

    hooks = [pipe.unet.register_forward_pre_hook(pre_hook, with_kwargs=True),
             pipe.unet.register_forward_hook(post_hook)]
    hooks += [m.register_forward_pre_hook(gn_hook(name))
              for name in ("unet", "vae", "denoise_encoder")
              for m in getattr(pipe, name).modules() if isinstance(m, GroupNorm)]

    img = np.random.default_rng(0).integers(
        0, 256, tuple(pixels) + (3,), dtype=np.uint8)
    prompt = torch.zeros((1, 77, 2048))
    pooled = torch.zeros((1, 1280))

    with attention_path(packed):
        _build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents = pipe(img, prompt, pooled, seed=0, output_type="latent")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pipe.decode(latents, img, output_type="uint8")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(_build.launches)
    for h in hooks:
        h.remove()
    for a, b in zip(events[::2], events[1::2]):
        unet_ms.append(a.elapsed_time(b))

    lh, lw = pixels[0] // 8, pixels[1] // 8
    if tuple(latents.shape) != (1, lh, lw, 4):
        fail(f"{label}: latents shape {tuple(latents.shape)}")
    if not bool(torch.isfinite(latents).all()):
        fail(f"{label}: latents are not finite")
    if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.shape == tuple(pixels) + (3,)):
        fail(f"{label}: output {type(out)} {getattr(out, 'shape', None)}")
    if len(unet_ms) != STEPS:
        fail(f"{label}: {len(unet_ms)} UNet calls, expected {STEPS}")
    unet_batch = last_call[0][0].shape[0]
    flash = "flash_attention_bsnd_fwd" if packed else "flash_attention_fwd"
    expected = {flash: STEPS * attn_unet}
    unet_routes = []
    for model, shape, itemsize, groups, aligned in gn_seen:
        plan = plan_group_norm(shape, itemsize, groups, aligned)
        for name in plan.counters:
            expected[name] = expected.get(name, 0) + 1
        if model == "unet":
            unet_routes.append(plan.route)
    if unet_routes != ["fused"] * (STEPS * gn_unet):
        fail(f"{label}: not every UNet GroupNorm is one single-pass launch: "
             f"{len(unet_routes)} calls, {unet_routes.count('fused')} fused")
    if counts != expected:
        fail(f"{label}: launch counts {counts}, expected {expected}")
    med = sorted(unet_ms)[STEPS // 2]
    result = dict(
        wall_s=t2 - t0, denoise_call_s=t1 - t0, decode_s=t2 - t1,
        unet_ms_per_step=sum(unet_ms) / len(unet_ms),
        unet_ms_first=unet_ms[0], unet_ms_min=min(unet_ms),
        unet_ms_median=med, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        steps=STEPS, tiles=unet_batch // 2, unet_batch=unet_batch,
        pixels=list(pixels), launches=counts, launches_as_planned=True,
        out_mean=float(out.mean()))
    print(label, json.dumps(result), flush=True)
    return counts, last_call


def check_path_parity(torch, unet, args, kwargs):
    """One UNet call on the packed path against the same call on the
    default path, same inputs."""
    with torch.no_grad():
        with attention_path(False):
            ref = unet(*args, **kwargs).float()
        with attention_path(True):
            got = unet(*args, **kwargs).float()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    result = dict(max_abs_err=err, max_abs_ref=scale,
                  mean_abs_err=float((got - ref).abs().mean()),
                  tol=f"{PARITY_TOL} * max|ref|",
                  ok=bool(torch.isfinite(got).all()) and err <= PARITY_TOL * scale)
    print("path_parity", json.dumps(result), flush=True)
    if not result["ok"]:
        fail(f"packed and default UNet calls disagree: {result}")


# lower-cased kernel-name fragments -> the layer they belong to, first
# match wins (cuDNN's convolution kernels carry "gemm" in their names too)
KERNEL_CLASSES = (("flash_bsnd_fwd_kernel", "packed flash attention (ours)"),
                  ("flash_fwd_kernel", "flash attention (ours)"),
                  ("nf4_ge", "NF4 dequant-matmul (ours)"),
                  ("::gn_", "GroupNorm (ours)"),
                  ("fprop", "convolution"), ("conv", "convolution"),
                  ("nchwtonhwc", "cuDNN layout transpose"),
                  ("nhwctonchw", "cuDNN layout transpose"),
                  ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
                  ("softmax", "softmax"), ("reduce", "reduction"),
                  ("copy", "copy / dtype cast"), ("elementwise", "elementwise"))


def profile_call(torch, label, module, args, kwargs):
    """One more call of `module` under torch.profiler: device time by layer
    and by kernel, and the device's busy share between its first and last
    kernel. The chrome trace is kept beside the built kernels, as
    faithdiff_tpu_torch/_build/<label>_trace.json."""
    from torch.profiler import ProfilerActivity, profile

    from faithdiff_tpu_torch.ops import _build

    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            module(*args, **kwargs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(_build.BUILD_DIR, f"{label}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        print(f"{label}: the trace holds no device kernels: not measured",
              flush=True)
        return None
    by_class, by_name = {}, {}
    for e in kernels:
        name = e["name"]
        cls = next((c for frag, c in KERNEL_CLASSES if frag in name.lower()),
                   "other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1e3
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for s, t in spans:
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    span_ms = (end - spans[0][0]) / 1e3
    kernel_ms = sum(by_class.values())
    result = dict(kernels=len(kernels), kernel_ms=kernel_ms, span_ms=span_ms,
                  busy_share=busy / 1e3 / span_ms, host_wall_ms=wall_ms,
                  by_layer={k: v for k, v in sorted(by_class.items(),
                                                    key=lambda kv: -kv[1])})
    print(label, json.dumps(result), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms  {ms / kernel_ms:6.1%}  {name[:110]}", flush=True)
    return result


def check_nf4(torch):
    """The NF4 kernel against its plain version at the captioner's shapes.
    The kernel streams each weight once per call, as the decode path does
    (280 different weights per token): its timed launches cycle through
    copies of the weight that together exceed the 50 MB L2. The kernel and
    the bf16 yardstick are timed from CUDA graphs (device time), the plain
    version from a loop of calls."""
    from faithdiff_tpu_torch.ops.nf4_matmul import (nf4_matmul_kernel,
                                                    nf4_matmul_reference)
    from faithdiff_tpu_torch.utils.quantize import dequantize_nf4, quantize_nf4

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    ms_checked = NF4_M + [caption_prefill_m()]
    for in_f, out_f in NF4_SHAPES:
        w = (torch.randn((in_f, out_f), generator=gen, device="cuda")
             * in_f ** -0.5).to(torch.bfloat16)
        q = quantize_nf4(w)
        del w
        w_dec = dequantize_nf4(q, torch.bfloat16).T.contiguous()   # [out, in]
        weight_bytes = q.packed.numel() + q.absmax.numel() * 4
        copies = [q] + [q._replace(packed=q.packed.clone(), absmax=q.absmax.clone())
                        for _ in range(int(2 * 50e6 // weight_bytes))]
        for m in ms_checked:
            x = torch.randn((m, in_f), generator=gen, device="cuda").to(torch.bfloat16)
            out = nf4_matmul_kernel(x, q)
            torch.cuda.synchronize()
            ref = nf4_matmul_reference(x, q)
            err = (out.float() - ref.float()).abs()
            # both round each decoded weight to bf16 once and multiply it
            # exactly; the fp32 sums run in another order, which can move
            # the one bf16 rounding of the output by a step (2^-8 relative)
            tol = 1e-2 * (1 + ref.float().abs())
            ok = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
            turn = iter(range(1 << 30))

            def cold():
                return nf4_matmul_kernel(x, copies[next(turn) % len(copies)])

            b_ms, b_by = bound(2 * m * in_f * out_f,
                               weight_bytes + m * in_f * 2 + m * out_f * 2,
                               PEAK_BF16_FLOPS)
            row = dict(m=m, in_f=in_f, out_f=out_f, max_abs_err=float(err.max()),
                       tol="1e-2*(1+|ref|)", ok=ok,
                       ms=graph_ms(torch, cold),
                       plain_ms=time_ms(torch, lambda: nf4_matmul_reference(x, q), 3, 1),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       decoded_bf16_matmul_ms=graph_ms(
                           torch, lambda: torch.matmul(x, w_dec.T)))
            print("nf4_matmul", json.dumps(row), flush=True)
            rows.append(row)
        del q, w_dec, copies, x, out, ref, err, tol
        torch.cuda.empty_cache()
    print("  (decoded_bf16_matmul_ms: torch.matmul of x with the weight already "
          "decoded to bf16, context only: no single PyTorch call computes the NF4 "
          "dequant-matmul)", flush=True)
    return rows


class WordTokenizer:
    """Deterministic stand-in for LLaMA's SentencePiece tokenizer, whose
    files are not in the repository: one id per word or punctuation mark,
    given in order of first use from 3 on; BOS 1, EOS 2. It keeps every id
    sequence it decodes."""

    eos_token_id = 2

    def __init__(self):
        self.vocab, self.decoded = {}, []

    def __call__(self, text, add_special_tokens=True, return_tensors=None):
        import numpy as np

        ids = [self.vocab.setdefault(w, 3 + len(self.vocab))
               for w in re.findall(r"\w+|[^\w\s]", text)]
        ids = ([1] if add_special_tokens else []) + ids
        return types.SimpleNamespace(input_ids=np.asarray([ids], np.int64))

    def decode(self, ids, skip_special_tokens=True):
        self.decoded.append([int(i) for i in ids])
        words = {v: k for k, v in self.vocab.items()}
        return " ".join(words.get(int(i), f"<{int(i)}>") for i in ids
                        if not (skip_special_tokens and int(i) < 3))


def caption_prompt_len(tok) -> int:
    """Tokens of the caption's prompt: the Vicuna text around the 576
    image tokens of one ViT-L/14-336 image (the pad path)."""
    from faithdiff_tpu_torch.captioner.agent import build_vicuna_prompt

    pre, post = build_vicuna_prompt("Describe this image and its style in a very "
                                    "detailed manner.")
    return (tok(pre).input_ids.shape[1] + 576
            + tok(post, add_special_tokens=False).input_ids.shape[1])


def caption_prefill_m() -> int:
    """Rows of every NF4 launch of the caption's prefill: batch x prompt."""
    return len(CAPTION_IMAGES) * caption_prompt_len(WordTokenizer())


def check_caption_small(torch):
    """A tiny nf4 LLaMA on the card (the NF4 kernel, bf16) against the same
    weights on the CPU (the plain version, fp32): prefill logits (the
    tiled path, M = 24) and one-row logits (the M <= 8 path)."""
    import dataclasses

    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig,
                                                     LlamaForCausalLM,
                                                     random_init_quantized_)
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig.tiny(), quant="nf4")
    cpu = LlamaForCausalLM(cfg).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(3)
    random_init_(cpu, gen)
    random_init_quantized_(cpu, gen)
    with torch.device("cuda"):
        card = LlamaForCausalLM(cfg, dtype=torch.bfloat16).eval().requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    emb = torch.randn((2, 12, cfg.hidden_size), generator=gen)
    pos = torch.arange(12)[None].expand(2, 12)
    worst = 0.0
    with torch.no_grad():
        for e, p in ((emb, pos), (emb[:1, :1], pos[:1, :1])):
            _build.launches.clear()
            ref, _ = cpu(e, p)
            got, _ = card(e.cuda().bfloat16(), p.cuda())
            torch.cuda.synchronize()
            if _build.launches["nf4_matmul"] != 7 * cfg.num_hidden_layers:
                fail(f"tiny captioner: {dict(_build.launches)} launches")
            err = (got.float().cpu() - ref).abs()
            # bf16 activations and weights against fp32 through two layers
            if not bool((err <= 5e-2 * (1 + ref.abs())).all()):
                fail(f"tiny captioner logits off the CPU reference: max {float(err.max())}")
            worst = max(worst, float(err.max()))
    print(f"caption_small: tiny nf4 LLaMA on the card vs the CPU plain version, "
          f"max |logit err| {worst:.4g} (tol 5e-2*(1+|ref|))", flush=True)


def check_llama_prefill(torch):
    """The causal prefill of the full-width 13B LLaMA's first two layers
    (nf4, bf16, seeded random weights) over a 1024-token prompt: the
    flash kernel at head dim 128, once a layer."""
    import dataclasses

    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig,
                                                     LlamaForCausalLM,
                                                     random_init_quantized_)
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig(quant="nf4"),
                              num_hidden_layers=PREFILL_LAYERS)
    with torch.device("cuda"):
        model = LlamaForCausalLM(cfg, dtype=torch.bfloat16).eval().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(6)
    random_init_(model, gen)
    random_init_quantized_(model, gen)
    emb = torch.randn((1, PREFILL_TOKENS, cfg.hidden_size), generator=gen,
                      device="cuda").to(torch.bfloat16)
    pos = torch.arange(PREFILL_TOKENS, device="cuda")[None]
    with torch.no_grad():
        model(emb, pos)                                     # warm-up
        _build.launches.clear()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        logits, _ = model(emb, pos)
        end.record()
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    expected = {"flash_attention_fwd": PREFILL_LAYERS,
                "nf4_matmul": 7 * PREFILL_LAYERS}
    if counts != expected:
        fail(f"13B prefill launch counts {counts}, expected {expected}")
    if tuple(logits.shape) != (1, PREFILL_TOKENS, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"13B prefill logits {tuple(logits.shape)} not finite or misshapen")
    print("llama_prefill", json.dumps(dict(
        layers=PREFILL_LAYERS, tokens=PREFILL_TOKENS, head_dim=128,
        ms=start.elapsed_time(end), launches=counts)), flush=True)
    del model, emb, logits
    torch.cuda.empty_cache()


def run_bench(torch):
    """The attention-variant benchmark's entry point, as a user runs it."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.attention_variants import VARIANTS
    from faithdiff_tpu_torch.scripts import bench_attention_variants as bench

    _build.launches.clear()
    rows = bench.main()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    if len(rows) != len(bench.SHAPES) * len(VARIANTS):
        fail(f"bench: {len(rows)} rows")
    # the variants differ from the first one by the bf16 roundings of q
    # and p; outputs are averages of N(0, 1) values, |o| << 1
    bad = [r for r in rows if not r["max_err_vs_first"] <= 2e-2]
    if bad:
        fail(f"bench: variants disagree: {bad}")
    if not counts.get("attention_variant_fwd") or set(counts) != {"attention_variant_fwd"}:
        fail(f"bench launch counts {counts}")
    print("bench_attention_variants", json.dumps(dict(launches=counts)), flush=True)
    return counts


def run_caption(torch):
    """The captioner's main path: build_caption_agent() at full width (13B
    LLaMA nf4, ViT-L/14-336), one caption_batch of two images."""
    import numpy as np

    from faithdiff_tpu_torch.captioner import (CLIPVisionConfig, LlamaConfig,
                                               build_caption_agent)
    from faithdiff_tpu_torch.ops import _build

    tok = WordTokenizer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agent = build_caption_agent(tok, LlamaConfig(quant="nf4"), CLIPVisionConfig(),
                                dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    print(f"caption: built LLaVA-1.5-13B nf4 + ViT-L/14-336 in {build_s:.1f} s "
          f"(init + quantise on the card), {weights_gib:.2f} GiB", flush=True)
    if (agent.temperature, agent.top_p, agent.max_new_tokens) != (0.2, 0.7, 512):
        fail("caption agent defaults changed")
    agent.max_new_tokens = CAPTION_NEW_TOKENS

    calls, finite = [], []

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    last = []

    def lm_pre(module, args, kwargs):
        calls.append([record(), None, args[0].shape[1], args[0].shape[0]])
        last[:] = [args, kwargs]

    def lm_post(module, args, out):
        calls[-1][1] = record()
        finite.append(torch.isfinite(out[0]).all())

    vis = []
    hooks = [agent.llama.register_forward_pre_hook(lm_pre, with_kwargs=True),
             agent.llama.register_forward_hook(lm_post),
             agent.vision.register_forward_pre_hook(lambda m, a: vis.append(record())),
             agent.projector.register_forward_hook(lambda m, a, o: vis.append(record()))]

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in CAPTION_IMAGES]
    _build.launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    captions = agent.caption_batch(images, seed=0)
    end = record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    for h in hooks:
        h.remove()

    n_prompt = caption_prompt_len(tok)
    n_fwd = len(calls)
    if calls[0][2] != n_prompt or any(c[2] != 1 for c in calls[1:]):
        fail(f"prompt length {calls[0][2]}, expected {n_prompt}")
    if calls[0][2] * calls[0][3] != caption_prefill_m():
        fail(f"prefill rows {calls[0][2]} x {calls[0][3]} are not the M check_nf4 held")
    if not bool(torch.stack(finite).all()):
        fail("caption logits are not finite")
    if len(captions) != 2 or len(tok.decoded) != 2:
        fail(f"{len(captions)} captions")
    for ids in tok.decoded:
        if not ids or not all(0 <= i < 32000 for i in ids):
            fail(f"caption tokens out of range or empty: {ids[:10]}")
    if n_fwd < 2 or n_fwd > CAPTION_NEW_TOKENS:
        fail(f"{n_fwd} forward passes")
    if counts != {"nf4_matmul": NF4_PER_FORWARD * n_fwd}:
        fail(f"launch counts {counts}, expected nf4_matmul = {NF4_PER_FORWARD} x {n_fwd}")
    prefill_ms = calls[0][0].elapsed_time(calls[0][1])
    decode_ms = calls[0][1].elapsed_time(end)
    n_decode = n_fwd - 1
    result = dict(
        build_s=build_s, wall_s=wall_s,
        vision_projector_ms=vis[0].elapsed_time(vis[1]),
        prefill_ms=prefill_ms, prompt_len=n_prompt, batch=len(images),
        decode_steps=n_decode, decode_ms_per_step=decode_ms / n_decode,
        decode_forward_ms_per_step=sum(c[0].elapsed_time(c[1]) for c in calls[1:]) / n_decode,
        tokens_per_s=len(images) * n_decode / (decode_ms / 1e3),
        lengths=[len(ids) for ids in tok.decoded],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=counts)
    print("caption", json.dumps(result), flush=True)
    for c in captions:
        print(f"  caption ({len(c)} chars): {c[:100]!r}", flush=True)
    # the last decode step once more (its cache slot is rewritten in place
    # with the same values)
    profile_call(torch, "profile_decode", agent.llama, *last)
    return counts


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "faithdiff_tpu_torch")):
        print("chip_smoke: faithdiff_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from faithdiff_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (parallel nvcc: "
          f"{_build.build_log.get('seconds', 0.0):.1f} s)", flush=True)
    for name in _build.SOURCES:
        print_ptxas(name, _build.build_log.get(name, ""))

    attn = check_attention(torch)
    packed = check_attention_packed(torch)
    ragged = check_attention_ragged(torch)
    variants = check_attention_variants(torch)
    fused, stats, apply_ = check_group_norm(torch)
    bad = [r for r in attn + packed + ragged + variants + fused + stats + apply_
           if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad}")

    pipe = build_restore(torch)
    counts, (args, kwargs) = run_restore(torch, pipe, packed=False)
    with attention_path(False):
        profile_call(torch, "profile", pipe.unet, args, kwargs)
    packed_counts, (args, kwargs) = run_restore(torch, pipe, packed=True)
    with attention_path(True):
        profile_call(torch, "profile_packed", pipe.unet, args, kwargs)
    check_path_parity(torch, pipe.unet, args, kwargs)
    del args, kwargs
    if not all(counts.get(k) for k in ("group_norm_fused", "group_norm_stats",
                                       "group_norm_apply")):
        fail(f"restore did not launch every GroupNorm kernel: {counts}")
    _, (args, kwargs) = run_restore(torch, pipe, packed=False,
                                    pixels=LARGE_PIXELS, label="restore_large")
    if args[0].shape[0] != 2 * LARGE_TILES:
        fail(f"restore_large: UNet batch {args[0].shape[0]}, expected "
             f"{2 * LARGE_TILES} ({LARGE_TILES} tiles)")
    del pipe, args, kwargs
    gc.collect()
    torch.cuda.empty_cache()
    bench_counts = run_bench(torch)

    nf4 = check_nf4(torch)
    bad = [r for r in nf4 if not r["ok"]]
    if bad:
        fail(f"{len(bad)} NF4 kernel checks out of tolerance: {bad}")
    check_caption_small(torch)
    check_llama_prefill(torch)
    caption_counts = run_caption(torch)

    def entry(name, row, source, replaces, launches=counts):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=row["max_abs_err"],
                    ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row["library_ms"])

    kernels = [
        entry("flash_attention_fwd", attn[ATTN_REPORT],
              "faithdiff_tpu_torch/csrc/flash_attention.cu",
              "faithdiff_tpu/ops/attention.py:45"),
        entry("group_norm_fused",
              next(r for r in fused if r["shape"] == list(GN_SHAPES[GN_REPORT][0])),
              "faithdiff_tpu_torch/csrc/group_norm.cu",
              "faithdiff_tpu/ops/groupnorm.py:33 and :92 (_stats_kernel, _apply_kernel)"),
        entry("group_norm_stats", stats[GN_REPORT],
              "faithdiff_tpu_torch/csrc/group_norm.cu",
              "faithdiff_tpu/ops/groupnorm.py:33"),
        entry("group_norm_apply", apply_[GN_REPORT],
              "faithdiff_tpu_torch/csrc/group_norm.cu",
              "faithdiff_tpu/ops/groupnorm.py:92"),
        entry("nf4_matmul",
              next(r for r in nf4 if (r["m"], r["in_f"], r["out_f"]) == NF4_REPORT),
              "faithdiff_tpu_torch/csrc/nf4_matmul.cu",
              "faithdiff_tpu/ops/nf4_matmul.py:73", caption_counts),
        entry("flash_attention_bsnd_fwd", packed[PACKED_REPORT],
              "faithdiff_tpu_torch/csrc/flash_attention.cu",
              "faithdiff_tpu/ops/attention.py:101", packed_counts),
        entry("attention_variant_fwd",
              next(r for r in variants
                   if (tuple(r["shape"]), r["base2"], r["block_k"]) == VARIANT_REPORT),
              "faithdiff_tpu_torch/csrc/flash_attention.cu",
              "scripts/bench_attention_variants.py:36", bench_counts),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
