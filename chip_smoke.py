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
5b'. `cli_restore`: the restore pipeline's weights written in the
   reference's file layout (the SDXL UNet's safetensors file in bf16,
   FaithDiff.bin, the VAE's safetensors file) under
   `faithdiff_tpu_torch/_build/`, converted by the port's `convert_cli`,
   then `faithdiff_tpu_torch.cli.main(["restore", ...])` with the default
   flags on a seeded 512x768 PNG: the weights it loads (strictly) must be
   the pipeline's, its 1024x1536 PNG identical in every byte to the
   in-memory pipeline's uint8 output on `resize_lanczos` of the same image,
   its launches as planned. `cli_restore_tiled`: the same CLI with
   `--upscale 2 --use_tile_vae --hdr 0.5 --color_fix adain` on a seeded
   1000x1000 PNG: a (2000, 2000, 3) output, finite latents, 9 latent tiles
   (18 UNet rows a step, in the CLI's chunks), the encode, denoise-encoder and decode tiles of the
   tiling formula, launches as planned. Both print write / convert / load
   seconds and the CLI's read, encode, HDR, resize, pipeline and write
   seconds. `cli_restore_prompt`: seeded full-width text towers written
   as SDXL ships them (fp16 `text_encoder*/model.safetensors`) and
   tokenizer dirs of a synthetic 49408-symbol vocabulary (BOS / EOS at
   49406 / 49407, `tokenizer_2` padding with `!`), converted, then the CLI
   with `--tokenizer_dir`, a caption JSON and `--negative_prompt` on
   `cli_restore`'s PNG: identical in every byte to the in-memory pipeline
   given the port's own encodes of the same texts, and unlike the
   zero-embed output. The in-memory pipelines of the CLI phases run the
   CLI's `TILE_CHUNK`. The weight files are deleted afterwards, also when
   a phase fails.
5b''. `restore_large`: the same pipeline on a 2048x3072 uint8 image (a
   1024x1536 photo at the CLI's default --upscale 2): 15 latent tiles, UNet
   batch 30, 20 steps, the default attention path; checks the output
   shape, finite latents, 20 UNet calls and the planned GroupNorm launches,
   and prints wall, denoise and decode seconds, the UNet call medians,
   peak memory and the launches. `chunk_parity`: its first UNet call
   unchunked against chunks of the CLI's `TILE_CHUNK`, on both attention
   paths, beside the same call with its tiles reversed.
   `tile_chunk_sweep`: one full-width UNet call at chunks of 1-24 tiles
   (UNet batch 2-48), the median of 3 by CUDA events, the peak memory,
   the pick (lowest ms per tile leaving 40 GiB free) and profiles at the
   pick and the next chunk up. `restore_4k`: a 4096x4096 restore (49
   tiles) with `use_tiled_vae` and the CLI's chunk, keeping canvases, then
   a resume after deleting the last two: 2 * ceil(49 / c) UNet calls and
   the same bytes; its checks as `restore_large`'s. Then frees the
   pipeline. `text_towers`: the full-width SDXL text towers, bf16 on the
   card, against fp32 on the CPU over 4 prompts of the port's BPE.
5b'''. `vae_chunk_trap`: one `chunked_attention` call as the untiled VAE
   decode of a 2000x2000 image runs it ([1, 1, 62500, 512] bf16, chunk 4,
   15,625 loop steps) against the same call at kv 65,536 (chunk 1024).
5c. Runs the attention-variant benchmark's entry point
   (`faithdiff_tpu_torch.scripts.bench_attention_variants.main`) and
   checks its launches.
6. Holds the NF4 dequant-matmul kernel against its
   plain version at the 13B captioner's shapes (M = 1, 2, 4, 8 on the
   decode route; 16, a decode step of 16 images, 640 and the caption's own
   prefill M, 2 x the prompt length, on the prefill route), with its
   bound, the time over the bound,
   the route that served it, the same bits on two calls and, as context
   only, a bf16 matmul against the decoded weight.
7. Holds a tiny nf4 captioner LLaMA on the card (kernel) against the same
   weights on the CPU (plain version, fp32), and runs the causal prefill
   of the full-width 13B LLaMA's first two layers over 1024 tokens, which
   goes through the flash kernel at head dim 128.
8. Captions two images with the full-width LLaVA-1.5-13B captioner
   (`quant="nf4"`, ViT-L/14-336, mlp2x projector; bf16, seeded random
   weights; the agent's defaults: temperature 0.2, top-p 0.7, 512 new
   tokens) and checks the prompt, the tokens, finite logits and that the
   NF4 kernel ran 280 times (7 projections x 40 layers) per forward pass,
   on the prefill route for the prefill and the decode route for each
   decode forward;
   then profiles the prefill and the last decode step as step 5 profiles
   the UNet.
8b. `caption_int8`: the same caption with `quant="int8"` (the caption
   CLI's default, plain torch): the same checks, no counted launch, and a
   profile of its last decode step. `cli_caption`: seeded LLaVA-1.5-13B
   weights at full width and 8 of its 40 layers (a cut for disk space:
   ~6.6 GB fp16) written as the reference ships them (two `.bin` shards
   and their index, `model.mm_projector.*`, a 32000-piece
   `tokenizer.model` and its JSON files, a whole CLIPModel ViT-L/14-336
   `.bin`), converted by `convert_cli --llava --clip_vision`, then
   `cli.main(["caption", ...])` on two seeded PNGs: buffers equal to the
   int8 quantisation of the written weights, each JSON caption equal to
   the in-memory agent's, a second call skipping both images,
   `--use_bsrnet` the same JSON; then `from_checkpoint(load_4bit=True)`:
   the nf4 buffers, one caption, 56 NF4 launches a forward on the right
   routes. The files are deleted afterwards, also when the phase fails.
   `bsrnet`: the full-width RRDBNet (x4) in bf16, `deg_remove` of a
   1024x1536 image (6 tiles -> 4096x6144), a 64x64 crop against fp32 on
   the CPU.
9. Prints the card line, a JSON line listing every ported kernel, then a
   last JSON line `{"ok": true, "device": {...}}`, only when every phase
   passed. Each phase prints its wall seconds (`phase <name>: <s> s`).

Imports nothing of JAX. Exits nonzero on any failure.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
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
# the CLI phases' photos: 512x768 at the default --upscale 2 is the
# restore's 1024x1536; 1000x1000 at --upscale 2 --use_tile_vae gives 9
# latent tiles and VAE tiles of 1024 px with a ragged edge
CLI_PIXELS, TILED_PIXELS, TILED_LATENT_TILES = (512, 768), (1000, 1000), 9
# a 1024x1536 photo at the CLI's default --upscale 2: 15 latent tiles of
# 128^2, UNet batch 30 (B*C up to 76,800 rows in its ResNet norms)
LARGE_PIXELS, LARGE_TILES = (2048, 3072), 15
STEPS = 20
# tiles per UNet call the sweep times, and the memory a chunk must leave
# free beside it: the 13B captioner's peak is 10.69 GiB (PERF.md)
SWEEP_CHUNKS = (1, 2, 4, 8, 12, 16, 24)
FREE_GIB_FOR_CAPTIONER = 40
# a 2048^2 photo at the CLI's default --upscale 2: 49 latent tiles of 128^2
FOUR_K_PIXELS, FOUR_K_TILES = (4096, 4096), 49
# the towers add each layer's output to a bf16 residual stream that
# reaches |x| ~ 27 in bigG's 31 layers with seeded weights (a bf16 step of
# 0.125 there): on an H100 an element of the prompt embeds differed from
# fp32 by 0.66, past 5e-2 * (1 + |ref|) at that element, with mean errors
# of 1.1% (prompt embeds) and 1.3% (pooled) of the mean |ref|; a wrong
# mask, activation or weight moves the mean error by tens of percent
TOWER_MEAN_TOL = 2e-2
TOWER_PROMPTS = [
    "a photo of a red house with a wooden door",
    "",
    "the cat's toys, a ball and a mouse, lie on the blue rug by the window",
    " ".join(["a tall green tree beside the old stone wall"] * 12),
]
PROMPT_CAPTION = ("The image shows a small red house with a white door. "
                  "A cat sits on the steps in the sun. The sky is blue.")

# the 13B LLaMA projections (in, out): q/k/v/o, gate/up, down; M = B at
# decode (the decode route takes up to 8, the prefill route a batch of 16)
# and B * prompt length at prefill. check_nf4 adds the caption's own
# prefill M (caption_prefill_m), whose last x tile is partial.
NF4_SHAPES = [(5120, 5120), (5120, 13824), (13824, 5120)]
NF4_M = [1, 2, 4, 8, 16, 640]
NF4_GEMV_MAX_M = 8                       # M of the decode route: nf4_gemv, above nf4_gemm
NF4_REPORT = (1, 5120, 13824)            # (M, in, out) of the kernels entry
CAPTION_IMAGES = [(768, 1024), (1024, 768)]
CAPTION_NEW_TOKENS = 512
# cli_caption's LLaMA depth: 8 of the 13B's 40 layers at full width keep
# the reference-layout files at ~6.6 GB fp16 (and as much converted)
CLI_CAPTION_LAYERS = 8
# bsrnet: a 1024x1536 image in 512 px tiles (2 x 3) -> 4096x6144; a
# 64x64 crop through the 23 RRDB blocks (345 convolutions) in bf16 on the
# card against fp32 on the CPU
BSRNET_PIXELS, BSRNET_TILES = (1024, 1536), 6
BSRNET_TOL, BSRNET_MEAN_TOL = 5e-2, 2e-2        # x max|ref|, x mean|ref|
NF4_PER_FORWARD = 7 * 40                 # projections x layers of the 13B LLaMA
PREFILL_LAYERS, PREFILL_TOKENS = 2, 1024
# the packed and the default path run the self-attentions through the same
# tile arithmetic, and on an H100 they gave the same bits (max error 0);
# one bf16 step of the largest output leaves room only for a library call
# that sums the cross-attention's products in another order
PARITY_TOL = 2 ** -8                     # x max|default path's output|
# a chunk runs the UNet's GEMMs and convolutions at another batch, for
# which cuBLAS and cuDNN pick other kernels, and cuBLAS's stream-K GEMMs
# split K by an output tile's place: other orders of bf16 sums through
# ~100 layers. On an H100 the 15-tile call against chunks of 8 differed by
# 0.047 at max|ref| 3.22 (3 bf16 steps, 0.0146 max|ref|), and so did the
# same call with its tiles in reverse order
CHUNK_TOL = 2 ** -5                      # x max|unchunked output|


@contextlib.contextmanager
def phase(name: str):
    """Prints the block's wall seconds as `phase <name>: <s> s`."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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


def unet_counts(pipe):
    """(GroupNorms, self-attentions) of the full-width UNet, checked: every
    self-attention (attn1) runs at >= 1024 tokens at a 128^2 latent tile
    and so goes to a flash kernel."""
    from faithdiff_tpu_torch.models.layers import GroupNorm
    from faithdiff_tpu_torch.models.transformer2d import BasicTransformerBlock

    gn_unet = count_modules(pipe.unet, GroupNorm)
    attn_unet = count_modules(pipe.unet, BasicTransformerBlock)
    if (gn_unet, attn_unet) != (47, 70):
        fail(f"UNet has {gn_unet} GroupNorms and {attn_unet} self-attentions, "
             "expected 47 and 70")
    return gn_unet, attn_unet


class PathWatch:
    """Forward hooks on a pipeline's models for one run of its path: CUDA
    events around each UNet call, each call's batch, the first and the
    last call's (args, kwargs), and the (model, shape, itemsize, groups,
    aligned) of every GroupNorm call, from which the launch plan predicts
    the GroupNorm kernels' launches."""

    def __init__(self, torch, pipe):
        from faithdiff_tpu_torch.models.layers import GroupNorm

        self.events, self.last_call, self.gn_seen = [], [], []
        self.first_call, self.batches = [], []

        def record(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

        def pre_hook(module, args, kwargs):
            self.last_call[:] = [args, kwargs]
            if not self.first_call:
                self.first_call[:] = [args, kwargs]
            self.batches.append(args[0].shape[0])
            record()

        def gn_hook(model):
            def hook(module, args):
                x = args[0]
                self.gn_seen.append((model, tuple(x.shape), x.element_size(),
                                     module.num_groups, x.data_ptr() % 16 == 0))
            return hook

        self.hooks = [pipe.unet.register_forward_pre_hook(pre_hook, with_kwargs=True),
                      pipe.unet.register_forward_hook(record)]
        self.hooks += [m.register_forward_pre_hook(gn_hook(name))
                       for name in ("unet", "vae", "denoise_encoder")
                       for m in getattr(pipe, name).modules()
                       if isinstance(m, GroupNorm)]

    def remove(self):
        for h in self.hooks:
            h.remove()

    def unet_ms(self):
        return [a.elapsed_time(b) for a, b in zip(self.events[::2], self.events[1::2])]

    def expected_launches(self, label, flash, gn_unet, attn_unet):
        """{kernel counter: launches} the run should show: `flash` once per
        self-attention of each UNet call, each GroupNorm's kernels as
        `plan_group_norm` plans them; fails unless every UNet GroupNorm was
        one single-pass launch."""
        from faithdiff_tpu_torch.ops.groupnorm import plan_group_norm

        calls = len(self.events) // 2
        expected = {flash: calls * attn_unet}
        unet_routes = []
        for model, shape, itemsize, groups, aligned in self.gn_seen:
            plan = plan_group_norm(shape, itemsize, groups, aligned)
            for name in plan.counters:
                expected[name] = expected.get(name, 0) + 1
            if model == "unet":
                unet_routes.append(plan.route)
        if unet_routes != ["fused"] * (calls * gn_unet):
            fail(f"{label}: not every UNet GroupNorm is one single-pass launch: "
                 f"{len(unet_routes)} calls, {unet_routes.count('fused')} fused")
        return expected


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
    counts, the last and the first UNet call's (args, kwargs)."""
    import numpy as np

    from faithdiff_tpu_torch.ops import _build

    label = label or ("restore_packed" if packed else "restore")
    gn_unet, attn_unet = unet_counts(pipe)
    watch = PathWatch(torch, pipe)
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
    watch.remove()
    unet_ms = watch.unet_ms()

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
    unet_batch = watch.last_call[0][0].shape[0]
    flash = "flash_attention_bsnd_fwd" if packed else "flash_attention_fwd"
    expected = watch.expected_launches(label, flash, gn_unet, attn_unet)
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
    return counts, watch.last_call, watch.first_call


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


def write_reference_weights(torch, pipe, root: str) -> dict:
    """The pipeline's weights in the reference's file layout under `root`:
    `sdxl/unet/diffusion_pytorch_model.safetensors` (core UNet keys, bf16),
    `FaithDiff.bin` (fusion modules and `denoise_encoder.*`) and
    `vae/diffusion_pytorch_model.safetensors`. Returns {file: bytes}."""
    from faithdiff_tpu_torch.utils.convert import (export_faithdiff_bin,
                                                   split_faithdiff_bin)
    from faithdiff_tpu_torch.utils.safetensors import save_file

    core, extras = split_faithdiff_bin(export_faithdiff_bin(
        pipe.unet.state_dict(), pipe.denoise_encoder.state_dict()))
    files = {"sdxl/unet/diffusion_pytorch_model.safetensors": core,
             "vae/diffusion_pytorch_model.safetensors": pipe.vae.state_dict()}
    for rel, sd in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        save_file(sd, os.path.join(root, rel))
    torch.save({f"{ns}.{k}": v.cpu() for ns, sd in extras.items()
                for k, v in sd.items()}, os.path.join(root, "FaithDiff.bin"))
    return {rel: os.path.getsize(os.path.join(root, rel))
            for rel in list(files) + ["FaithDiff.bin"]}


def run_cli(argv):
    """`faithdiff_tpu_torch.cli.main(argv)` with its output echoed; returns
    {name: seconds} of the `restored` line's read / encode / hdr / resize /
    pipeline / write split and the call's wall seconds."""
    import io

    from faithdiff_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"cli {argv[0]} returned {rc}")
    split = dict((k, float(v)) for k, v in
                 re.findall(r"(\w+_s)=([0-9.]+)", out.getvalue()))
    if set(split) != {"read_s", "encode_s", "hdr_s", "resize_s", "pipeline_s",
                      "write_s"}:
        fail(f"cli printed no restore line: {out.getvalue()!r}")
    return dict(split, cli_wall_s=wall)


@contextlib.contextmanager
def cli_pipeline_watch(torch, hooks=()):
    """Within the block, the pipeline the CLI builds is recorded with its
    load seconds and a `PathWatch` on it (`seen["watch"]`), and every VAE
    decode call's latents' finiteness and seconds. `hooks` are (module
    name, forward hook) pairs to register on the pipeline's models."""
    from faithdiff_tpu_torch import cli

    seen = {"decode_s": 0.0, "latents_finite": True, "handles": []}
    build = cli.load_checkpointed_pipeline

    def watched(args):
        t0 = time.perf_counter()
        pipe = build(args)
        torch.cuda.synchronize()
        seen.update(pipe=pipe, load_s=time.perf_counter() - t0,
                    watch=PathWatch(torch, pipe))
        for path, hook in hooks:
            module = pipe
            for name in path.split("."):
                module = getattr(module, name)
            seen["handles"].append(module.register_forward_hook(hook))
        decode = pipe.vae_decode

        def timed_decode(latents):
            seen["latents_finite"] &= bool(torch.isfinite(latents).all())
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = decode(latents)
            torch.cuda.synchronize()
            seen["decode_s"] += time.perf_counter() - t
            return out

        pipe.vae_decode = timed_decode
        return pipe

    cli.load_checkpointed_pipeline = watched
    try:
        yield seen
    finally:
        cli.load_checkpointed_pipeline = build
        if "watch" in seen:
            seen["watch"].remove()
        for h in seen["handles"]:
            h.remove()


def run_cli_restore(torch, pipe, root: str) -> str:
    """`cli_restore`: the pipeline's weights written in the reference's
    layout, converted by the port's `convert_cli`, then `cli.main(["restore",
    ...])` with default flags on a seeded 512x768 PNG (upscale 2: 1024x1536,
    2 latent tiles). The PNG it writes must equal, byte for byte, the
    in-memory pipeline's uint8 output on `resize_lanczos` of the same image.
    Returns the converted checkpoint dir."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import convert_cli
    from faithdiff_tpu_torch.utils.image import check_image_size
    from faithdiff_tpu_torch.utils.png import read_png, write_png
    from faithdiff_tpu_torch.utils.resample import resize_lanczos
    from faithdiff_tpu_torch.utils.safetensors import load_file

    free_gb = shutil.disk_usage(os.path.dirname(root)).free / 1e9
    print(f"cli_restore: {free_gb:.1f} GB free beside {root}; the reference "
          "files take ~5.5 GB and the converted copy as much again", flush=True)
    t0 = time.perf_counter()
    sizes = write_reference_weights(torch, pipe, root)
    t1 = time.perf_counter()
    ckpt = os.path.join(root, "ckpt")
    convert_cli.main(["--sdxl_dir", os.path.join(root, "sdxl"),
                      "--faithdiff_bin", os.path.join(root, "FaithDiff.bin"),
                      "--vae_dir", os.path.join(root, "vae"), "--out_dir", ckpt])
    t2 = time.perf_counter()
    keys = {name: len(load_file(os.path.join(ckpt, name, convert_cli.MODEL_FILE)))
            for name in ("unet", "vae", "denoise_encoder")}

    img = np.random.default_rng(11).integers(0, 256, CLI_PIXELS + (3,),
                                             dtype=np.uint8)
    os.makedirs(os.path.join(root, "in"))
    write_png(os.path.join(root, "in", "photo.png"), img)
    gn_unet, attn_unet = unet_counts(pipe)
    with cli_pipeline_watch(torch) as seen:
        _build.launches.clear()
        split = run_cli(["restore", "--img_dir", os.path.join(root, "in"),
                         "--save_dir", os.path.join(root, "out"),
                         "--checkpoint_dir", ckpt])
        counts = dict(_build.launches)
    cli_pipe = seen.pop("pipe")
    expected = seen["watch"].expected_launches("cli_restore", "flash_attention_fwd",
                                               gn_unet, attn_unet)
    if counts != expected:
        fail(f"cli_restore: launch counts {counts}, expected {expected}")
    # the weights the CLI loaded strictly are the in-memory pipeline's
    for name in ("unet", "vae", "denoise_encoder"):
        mine = getattr(pipe, name).state_dict()
        theirs = getattr(cli_pipe, name).state_dict()
        if sorted(mine) != sorted(theirs) or len(mine) != keys[name] or not all(
                torch.equal(mine[k], theirs[k]) for k in mine):
            fail(f"cli_restore: {name} weights differ after the round trip")
    del cli_pipe
    torch.cuda.empty_cache()

    got = read_png(os.path.join(root, "out", "photo.png"))
    h, w = CLI_PIXELS
    padded, w0, h0, _, _ = check_image_size(resize_lanczos(img, (2 * w, 2 * h)))
    before = pipe.tile_chunk
    pipe.tile_chunk = cli.TILE_CHUNK
    try:
        want = pipe(padded, torch.zeros((1, 77, 2048)), torch.zeros((1, 1280)),
                    seed=42, output_type="uint8")[:h0, :w0]
    finally:
        pipe.tile_chunk = before
    if got.shape != want.shape:
        fail(f"cli_restore: output {got.shape}, in-memory {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if diff.any():
        fail(f"cli_restore: {int((diff.max(axis=2) > 0).sum())} pixels differ "
             f"from the in-memory pipeline, by up to {int(diff.max())}")
    result = dict(
        free_disk_gb=free_gb, file_bytes=sizes, keys_loaded_strict=keys,
        write_weights_s=t1 - t0, convert_s=t2 - t1, load_s=seen["load_s"],
        host_pre_s=split["read_s"] + split["resize_s"], **split,
        identical_to_in_memory=True, pixels=list(got.shape[:2]),
        launches=counts, launches_as_planned=True)
    print("cli_restore", json.dumps(result), flush=True)
    return ckpt


def run_cli_restore_tiled(torch, root: str, ckpt: str) -> None:
    """`cli_restore_tiled`: the CLI with `--upscale 2 --use_tile_vae --hdr
    0.5 --color_fix adain` on a seeded 1000x1000 PNG: a 2000x2000 restore,
    9 latent tiles (18 UNet rows a step, in the CLI's chunks), the VAE
    encode, the denoise encoder and the VAE decode over the tile grids of
    the JAX tiling formula, the color fix streamed; launches as planned."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.config import DenoiseEncoderConfig, VAEConfig
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils.png import read_png, write_png

    img = np.random.default_rng(12).integers(0, 256, TILED_PIXELS + (3,),
                                             dtype=np.uint8)
    os.makedirs(os.path.join(root, "in_tiled"))
    write_png(os.path.join(root, "in_tiled", "photo.png"), img)
    side = 2 * TILED_PIXELS[0]

    def grid(extent, tile, overlap):        # `tiled_apply`'s tiles on a square
        return len(range(0, extent, int(tile * (1 - overlap)))) ** 2

    vae_cfg, de_cfg = VAEConfig(), DenoiseEncoderConfig()
    want_tiles = dict(
        encode=grid(side, vae_cfg.tile_sample_min_size, vae_cfg.tile_overlap_factor),
        denoise_encoder=grid(side, de_cfg.tile_sample_min_size,
                             de_cfg.tile_overlap_factor),
        decode=grid(side // 8, vae_cfg.tile_latent_min_size,
                    vae_cfg.tile_overlap_factor))
    tiles = dict.fromkeys(want_tiles, 0)

    def counter(name):
        def hook(module, args, out):
            tiles[name] += args[0].shape[0]
        return hook

    hooks = [("vae.encoder", counter("encode")), ("vae.decoder", counter("decode")),
             ("denoise_encoder", counter("denoise_encoder"))]
    with cli_pipeline_watch(torch, hooks) as seen:
        _build.launches.clear()
        torch.cuda.reset_peak_memory_stats()
        split = run_cli(["restore", "--img_dir", os.path.join(root, "in_tiled"),
                         "--save_dir", os.path.join(root, "out_tiled"),
                         "--checkpoint_dir", ckpt, "--upscale", "2",
                         "--use_tile_vae", "--hdr", "0.5", "--color_fix", "adain"])
        counts = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pipe = seen.pop("pipe")
    gn_unet, attn_unet = unet_counts(pipe)
    unet_batches = seen["watch"].batches
    unet_ms = seen["watch"].unet_ms()
    expected = seen["watch"].expected_launches(
        "cli_restore_tiled", "flash_attention_fwd", gn_unet, attn_unet)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    out = read_png(os.path.join(root, "out_tiled", "photo.png"))
    if out.shape != (side, side, 3):
        fail(f"cli_restore_tiled: output {out.shape}")
    if not seen["latents_finite"]:
        fail("cli_restore_tiled: latents are not finite")
    if tiles != want_tiles:
        fail(f"cli_restore_tiled: tiles {tiles}, the tiling formula gives "
             f"{want_tiles}")
    # the CLI's chunks: ceil(9 / TILE_CHUNK) UNet calls a step, 18 rows in all
    calls_per_step = -(-TILED_LATENT_TILES // cli.TILE_CHUNK)
    if (sum(unet_batches) != 2 * TILED_LATENT_TILES * STEPS
            or max(unet_batches) > 2 * cli.TILE_CHUNK
            or len(unet_ms) != calls_per_step * STEPS):
        fail(f"cli_restore_tiled: UNet batches {sorted(set(unet_batches))} over "
             f"{len(unet_ms)} calls, expected {2 * TILED_LATENT_TILES} rows a "
             f"step in {calls_per_step} calls")
    if counts != expected:
        fail(f"cli_restore_tiled: launch counts {counts}, expected {expected}")
    result = dict(
        pixels=[side, side], tiles=tiles, unet_batches=sorted(set(unet_batches)),
        unet_calls=len(unet_ms),
        host_pre_s=split["read_s"] + split["resize_s"], **split,
        vae_decode_s=seen["decode_s"], load_s=seen["load_s"],
        unet_ms_median=median(unet_ms), peak_mem_gib=peak,
        out_mean=float(out.mean()), launches=counts, launches_as_planned=True)
    print("cli_restore_tiled", json.dumps(result), flush=True)


def check_vae_chunk_trap(torch) -> None:
    """One `chunked_attention` call as the untiled VAE decode of a 2000^2
    image runs it ([1, 1, 62500, 512] bf16: the chunk halves to 4, 15,625
    loop steps) against the same call at kv 65,536 (chunk 1024, 64 steps).
    Measured only: the port keeps the JAX package's arithmetic."""
    from faithdiff_tpu_torch.ops.attention import chunked_attention

    gen = torch.Generator(device="cuda").manual_seed(13)
    row = {}
    for n in (62500, 65536):
        q, k, v = (torch.randn((1, 1, n, 512), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        chunk = 1024
        while n % chunk:
            chunk //= 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chunked_attention(q, k, v, 512 ** -0.5)
        torch.cuda.synchronize()
        row[str(n)] = dict(chunk=chunk, loop_steps=n // chunk,
                           ms=(time.perf_counter() - t0) * 1e3,
                           finite=bool(torch.isfinite(out).all()))
        del q, k, v, out
        torch.cuda.empty_cache()
    print("vae_chunk_trap", json.dumps(row), flush=True)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def chunk_rows(args, rows: int, lo: int, hi: int):
    """The UNet call's positional arguments cut to model rows [lo, hi):
    every tensor with `rows` rows; the timestep stays whole."""
    return tuple(a[lo:hi] if getattr(a, "ndim", 0) and a.shape[0] == rows else a
                 for a in args)


def check_chunk_parity(torch, unet, args, kwargs, chunk: int) -> None:
    """`chunk_parity`: one UNet call over the 15 tiles of `restore_large`'s
    first step, unchunked, against the same inputs run as chunks of
    `chunk` tiles (2 * chunk model rows, each tile's CFG pair together),
    on both attention paths, within CHUNK_TOL * max|ref|. Beside it, the
    same call with its tiles in reverse order: the floor that other
    orders of summation alone give at the same batch (cuBLAS's stream-K
    GEMMs split K by an output tile's place)."""
    rows = args[0].shape[0]
    perm = torch.tensor([r for t in reversed(range(rows // 2))
                         for r in (2 * t, 2 * t + 1)])
    inverse = torch.argsort(perm)
    result = {}
    with torch.no_grad():
        for packed in (False, True):
            with attention_path(packed):
                ref = unet(*args, **kwargs).float()
                flipped = unet(*(a[perm.to(a.device)] if getattr(a, "ndim", 0)
                                 and a.shape[0] == rows else a for a in args),
                               **kwargs).float()[inverse.to(ref.device)]
                got = torch.cat([unet(*chunk_rows(args, rows, lo, lo + 2 * chunk),
                                      **kwargs).float()
                                 for lo in range(0, rows, 2 * chunk)])
            err = float((got - ref).abs().max())
            floor = float((flipped - ref).abs().max())
            scale = float(ref.abs().max())
            result["packed" if packed else "default"] = dict(
                max_abs_err=err, max_abs_ref=scale,
                mean_abs_err=float((got - ref).abs().mean()),
                reversed_max_abs_err=floor,
                ok=bool(torch.isfinite(got).all()) and err <= CHUNK_TOL * scale)
            del ref, got, flipped
    result.update(tiles=rows // 2, chunk=chunk,
                  calls=-(-rows // (2 * chunk)), tol=f"{CHUNK_TOL} * max|ref|")
    print("chunk_parity", json.dumps(result), flush=True)
    if not (result["default"]["ok"] and result["packed"]["ok"]):
        fail(f"chunked and unchunked UNet calls disagree: {result}")


def run_tile_chunk_sweep(torch, unet, args, kwargs) -> int:
    """`tile_chunk_sweep`: one full-width UNet call at 128^2 latent tiles,
    bf16, default attention path, for chunks of c in SWEEP_CHUNKS tiles
    (UNet batch 2c, the restore's first tile pair repeated): the median of
    3 calls after a warm-up (CUDA events) and the peak memory. Returns the
    chunk of the lowest ms per tile whose peak leaves FREE_GIB_FOR_CAPTIONER
    of the card free."""
    from faithdiff_tpu_torch import cli

    rows = args[0].shape[0]
    pair = chunk_rows(args, rows, 0, 2)
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    table = []
    with torch.no_grad(), attention_path(False):
        for c in SWEEP_CHUNKS:
            inputs = tuple(a.repeat(c, *([1] * (a.ndim - 1)))
                           if getattr(a, "ndim", 0) else a for a in pair)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            unet(*inputs, **kwargs)
            ms = []
            for _ in range(3):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                out = unet(*inputs, **kwargs)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not bool(torch.isfinite(out).all()):
                fail(f"tile_chunk_sweep: non-finite UNet output at chunk {c}")
            table.append(dict(chunk=c, unet_batch=2 * c, ms=median(ms),
                              ms_per_tile=median(ms) / c, ms_all=ms,
                              peak_gib=peak, free_gib=total_gib - peak))
            del inputs, out
    fits = [r for r in table if r["free_gib"] >= FREE_GIB_FOR_CAPTIONER]
    if not fits:
        fail(f"tile_chunk_sweep: no chunk leaves {FREE_GIB_FOR_CAPTIONER} GiB free")
    pick = min(fits, key=lambda r: r["ms_per_tile"])["chunk"]
    # where the time per tile jumps: the pick against the next chunk up
    for c in SWEEP_CHUNKS[SWEEP_CHUNKS.index(pick):][:2]:
        inputs = tuple(a.repeat(c, *([1] * (a.ndim - 1)))
                       if getattr(a, "ndim", 0) else a for a in pair)
        with attention_path(False):
            profile_call(torch, f"profile_chunk_{c}", unet, inputs, kwargs)
        del inputs
    print("tile_chunk_sweep", json.dumps(dict(
        rows=table, total_gib=total_gib, pick=pick,
        cli_tile_chunk=cli.TILE_CHUNK,
        rule=f"lowest ms_per_tile with free_gib >= {FREE_GIB_FOR_CAPTIONER}")),
        flush=True)
    torch.cuda.empty_cache()
    return pick


def run_restore_4k(torch, pipe, ckpt_dir: str) -> dict:
    """`restore_4k`: the pipeline with `use_tiled_vae` and the CLI's
    `TILE_CHUNK` on a seeded 4096x4096 uint8 image (a 2048^2 photo at the
    CLI's default --upscale 2): 49 latent tiles, 20 steps, canvas
    checkpoints under `ckpt_dir`. Checks the output, finite latents,
    ceil(49 / c) UNet calls a step at batch <= 2c and the planned
    launches; then deletes the last two canvases, runs again and demands
    2 * ceil(49 / c) UNet calls and the same bytes."""
    import dataclasses

    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.pipelines.factory import _tiled_stages

    chunk = cli.TILE_CHUNK
    tiled = dataclasses.replace(
        pipe, config=dataclasses.replace(pipe.config, use_tiled_vae=True),
        tile_chunk=chunk, **_tiled_stages(pipe.vae, pipe.denoise_encoder, True))
    gn_unet, attn_unet = unet_counts(tiled)
    img = np.random.default_rng(14).integers(0, 256, FOUR_K_PIXELS + (3,),
                                             dtype=np.uint8)
    prompt, pooled = torch.zeros((1, 77, 2048)), torch.zeros((1, 1280))
    calls_per_step = -(-FOUR_K_TILES // chunk)

    def run(label):
        watch = PathWatch(torch, tiled)
        _build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        latents = tiled(img, prompt, pooled, seed=0, output_type="latent",
                        checkpoint_dir=ckpt_dir)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = tiled.decode(latents, img, output_type="uint8")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(_build.launches)
        watch.remove()
        if not bool(torch.isfinite(latents).all()):
            fail(f"{label}: latents are not finite")
        if out.shape != FOUR_K_PIXELS + (3,) or out.dtype != np.uint8:
            fail(f"{label}: output {out.dtype} {out.shape}")
        if max(watch.batches) > 2 * chunk:
            fail(f"{label}: a UNet call at batch {max(watch.batches)} > {2 * chunk}")
        expected = watch.expected_launches(label, "flash_attention_fwd",
                                           gn_unet, attn_unet)
        if counts != expected:
            fail(f"{label}: launch counts {counts}, expected {expected}")
        unet_ms = watch.unet_ms()
        return out, counts, dict(
            wall_s=t2 - t0, denoise_call_s=t1 - t0, decode_s=t2 - t1,
            unet_calls=len(unet_ms), unet_batches=sorted(set(watch.batches)),
            unet_ms_median=median(unet_ms) if unet_ms else None,
            unet_ms_per_step=sum(unet_ms) / max(len(unet_ms) // calls_per_step, 1),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=counts, launches_as_planned=True)

    out, counts, first = run("restore_4k")
    if first["unet_calls"] != calls_per_step * STEPS:
        fail(f"restore_4k: {first['unet_calls']} UNet calls, expected "
             f"{calls_per_step * STEPS}")
    canvases = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("canvas_step"))
    if len(canvases) != STEPS:
        fail(f"restore_4k: canvases {canvases}")
    for step in (STEPS - 2, STEPS - 1):
        os.remove(os.path.join(ckpt_dir, f"canvas_step{step:04d}.npy"))
    resumed, _, second = run("restore_4k_resume")
    if second["unet_calls"] != 2 * calls_per_step:
        fail(f"restore_4k_resume: {second['unet_calls']} UNet calls, expected "
             f"{2 * calls_per_step}")
    if not np.array_equal(out, resumed):
        diff = np.abs(out.astype(np.int16) - resumed.astype(np.int16))
        fail(f"restore_4k_resume: {int((diff.max(axis=2) > 0).sum())} pixels "
             f"differ from the uninterrupted run, by up to {int(diff.max())}")
    print("restore_4k", json.dumps(dict(
        first, pixels=list(FOUR_K_PIXELS), tiles=FOUR_K_TILES, tile_chunk=chunk,
        steps=STEPS, canvases=len(canvases), out_mean=float(out.mean()),
        resume=dict(second, identical_bytes=True))), flush=True)
    return counts


def write_tokenizer_dirs(root: str) -> str:
    """SDXL-layout `tokenizer/` and `tokenizer_2/` under `root` over a
    synthetic vocabulary of CLIP's size, 49408: the 256 byte symbols, the
    same with `</w>`, 48894 merges that build lower-case words of up to
    four letters, then `<|startoftext|>` (49406) and `<|endoftext|>`
    (49407). `tokenizer_2` pads with `!` (id 0), as SDXL's does."""
    from faithdiff_tpu_torch.models.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    n_merges = 49152 - 256 - 2
    letters = "etaoinshrdlcumwfgypbvkjxqz"
    merges, words, seen = [], list(letters), set(vocab)
    for word in words:
        for b in letters:
            for second in (b, b + "</w>"):
                token = word + second
                if token not in seen and len(merges) < n_merges:
                    seen.add(token)
                    merges.append(f"{word} {second}")
                    vocab.append(token)
                    if not second.endswith("</w>"):
                        words.append(token)
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    if len(vocab) != 49408 or len(merges) != n_merges:
        fail(f"synthetic vocabulary: {len(vocab)} symbols, {len(merges)} merges")
    special = {k: {"content": v, "lstrip": False, "normalized": True,
                   "rstrip": False, "single_word": False}
               for k, v in (("bos_token", "<|startoftext|>"),
                            ("eos_token", "<|endoftext|>"),
                            ("unk_token", "<|endoftext|>"))}
    for name, pad in (("tokenizer", "<|endoftext|>"), ("tokenizer_2", "!")):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump({t: i for i, t in enumerate(vocab)}, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
            json.dump(dict(special, pad_token=pad), f)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"model_max_length": 77, "pad_token": pad,
                       "tokenizer_class": "CLIPTokenizer"}, f)
    return root


def check_text_towers(torch, tok_root: str) -> None:
    """`text_towers`: the full-width SDXLTextEncoder, bf16, seeded weights,
    on the card against the same weights in fp32 on the CPU over 4
    prompts tokenised by the port's BPE (one past 77 tokens): the largest
    error within 5e-2 * (1 + max|ref|), the mean error within
    TOWER_MEAN_TOL * mean|ref|; ms per encode of one prompt and of four."""
    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.models.clip_text import SDXLTextEncoder
    from faithdiff_tpu_torch.models.tokenizer import SDXLTokenizer

    tok = SDXLTokenizer(os.path.join(tok_root, "tokenizer"),
                        os.path.join(tok_root, "tokenizer_2"))
    ids_1, ids_2 = tok(TOWER_PROMPTS)
    truncated = sum(len(tok.tok_1.encode(p)) > 75 for p in TOWER_PROMPTS)
    if ids_1.shape != (4, 77) or truncated != 1 or int(ids_1[0, -1]) != 49407:
        fail(f"text_towers: ids {ids_1.shape}, {truncated} truncated prompts")
    enc = cli.build_text_encoder(False, "cuda", seed=5)
    ref_enc = SDXLTextEncoder().eval().requires_grad_(False)
    ref_enc.load_state_dict({k: v.float().cpu() for k, v in enc.state_dict().items()})
    t1, t2 = torch.from_numpy(ids_1), torch.from_numpy(ids_2)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = ref_enc(t1, t2)
        cpu_s = time.perf_counter() - t0
        got = enc(t1, t2)

        def timed(n):
            a, b = t1[:n].cuda(), t2[:n].cuda()
            return median([time_ms(torch, lambda: enc(a, b), 3, 1) for _ in range(3)])

        ms_1, ms_4 = timed(1), timed(4)
    rows = {}
    for name, g, r in (("prompt_embeds", got[0], ref[0]), ("pooled", got[1], ref[1])):
        g = g.float().cpu()
        err = (g - r).abs()
        rows[name] = dict(shape=list(g.shape), max_abs_err=float(err.max()),
                          max_abs_ref=float(r.abs().max()),
                          mean_abs_err=float(err.mean()),
                          mean_abs_ref=float(r.abs().mean()),
                          elementwise_ok=bool((err <= 5e-2 * (1 + r.abs())).all()),
                          ok=bool(torch.isfinite(g).all()
                                  and err.max() <= 5e-2 * (1 + r.abs().max())
                                  and err.mean() <= TOWER_MEAN_TOL * r.abs().mean()))
    print("text_towers", json.dumps(dict(
        rows, ms_per_encode_1=ms_1, ms_per_encode_4=ms_4, cpu_fp32_s=cpu_s,
        params_b=sum(p.numel() for p in enc.parameters()) / 1e9,
        tol=f"max 5e-2 * (1 + max|ref|), mean {TOWER_MEAN_TOL} * mean|ref|")),
        flush=True)
    if not all(r["ok"] for r in rows.values()):
        fail(f"text_towers: card and CPU disagree: {rows}")
    del enc, ref_enc
    gc.collect()
    torch.cuda.empty_cache()


def run_cli_restore_prompt(torch, pipe, root: str, ckpt: str) -> None:
    """`cli_restore_prompt`: seeded full-width towers written as SDXL ships
    them (`text_encoder*/model.safetensors`, fp16), tokenizer dirs of the
    synthetic 49408-symbol vocabulary, `convert_cli`, then the CLI with
    `--tokenizer_dir`, a caption JSON and `--negative_prompt blurry` on
    `cli_restore`'s PNG. Its PNG must equal, byte for byte, the in-memory
    pipeline (the CLI's tile chunk) given the port's own encodes of the
    same texts, and differ from `cli_restore`'s zero-embed output."""
    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.models.tokenizer import SDXLTokenizer
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import convert_cli
    from faithdiff_tpu_torch.utils.convert import TEXT_TOWERS
    from faithdiff_tpu_torch.utils.image import check_image_size
    from faithdiff_tpu_torch.utils.png import read_png
    from faithdiff_tpu_torch.utils.resample import resize_lanczos
    from faithdiff_tpu_torch.utils.safetensors import save_file

    t0 = time.perf_counter()
    enc = cli.build_text_encoder(False, "cuda", seed=7)
    for tower in TEXT_TOWERS:
        d = os.path.join(root, "sdxl", tower)
        os.makedirs(d, exist_ok=True)
        save_file({k: v.half() for k, v in getattr(enc, tower).state_dict().items()},
                  os.path.join(d, "model.safetensors"))
    tower_bytes = sum(os.path.getsize(os.path.join(root, "sdxl", t, "model.safetensors"))
                      for t in TEXT_TOWERS)
    del enc
    tok_root = write_tokenizer_dirs(os.path.join(root, "tok"))
    os.makedirs(os.path.join(root, "json"))
    with open(os.path.join(root, "json", "photo.json"), "w") as f:
        json.dump({"caption": PROMPT_CAPTION}, f)
    t1 = time.perf_counter()
    convert_cli.main(["--sdxl_dir", os.path.join(root, "sdxl"),
                      "--faithdiff_bin", os.path.join(root, "FaithDiff.bin"),
                      "--vae_dir", os.path.join(root, "vae"), "--out_dir", ckpt])
    t2 = time.perf_counter()

    seen_towers = []
    build = cli.build_text_encoder

    def watched(*a, **k):
        seen_towers.append(build(*a, **k))
        return seen_towers[-1]

    gn_unet, attn_unet = unet_counts(pipe)
    cli.build_text_encoder = watched
    try:
        with cli_pipeline_watch(torch) as seen:
            _build.launches.clear()
            split = run_cli(["restore", "--img_dir", os.path.join(root, "in"),
                             "--save_dir", os.path.join(root, "out_prompt"),
                             "--checkpoint_dir", ckpt, "--tokenizer_dir", tok_root,
                             "--json_dir", os.path.join(root, "json"),
                             "--negative_prompt", "blurry"])
            counts = dict(_build.launches)
    finally:
        cli.build_text_encoder = build
    seen.pop("pipe")
    expected = seen["watch"].expected_launches(
        "cli_restore_prompt", "flash_attention_fwd", gn_unet, attn_unet)
    if counts != expected:
        fail(f"cli_restore_prompt: launch counts {counts}, expected {expected}")
    gc.collect()
    torch.cuda.empty_cache()

    # the in-memory side: the converted towers, the port's tokenizer, the
    # caption as the CLI trims it
    (cli_enc,) = seen_towers
    enc = build(False, "cuda", cli.load_dir(os.path.join(ckpt, "text_encoders")))
    mine, theirs = enc.state_dict(), cli_enc.state_dict()
    if sorted(mine) != sorted(theirs) or not all(torch.equal(mine[k], theirs[k])
                                                for k in mine):
        fail("cli_restore_prompt: the CLI's towers differ from the written ones")
    tok = SDXLTokenizer(os.path.join(tok_root, "tokenizer"),
                        os.path.join(tok_root, "tokenizer_2"))
    caption = cli.trim_caption(PROMPT_CAPTION)
    with torch.no_grad():
        pe, pooled = (x.float() for x in enc(*map(torch.from_numpy, tok(caption))))
        npe, npooled = (x.float() for x in enc(*map(torch.from_numpy, tok("blurry"))))
    del enc, cli_enc, seen_towers[:]
    img = read_png(os.path.join(root, "in", "photo.png"))
    h, w = img.shape[:2]
    padded, w0, h0, _, _ = check_image_size(resize_lanczos(img, (2 * w, 2 * h)))
    before = pipe.tile_chunk
    pipe.tile_chunk = cli.TILE_CHUNK
    try:
        want = pipe(padded, pe, pooled, negative_prompt_embeds=npe,
                    negative_pooled_prompt_embeds=npooled, seed=42,
                    output_type="uint8")[:h0, :w0]
    finally:
        pipe.tile_chunk = before
    got = read_png(os.path.join(root, "out_prompt", "photo.png"))
    zero = read_png(os.path.join(root, "out", "photo.png"))
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        fail(f"cli_restore_prompt: {int((diff.max(axis=2) > 0).sum())} pixels "
             f"differ from the in-memory pipeline, by up to {int(diff.max())}")
    if np.array_equal(got, zero):
        fail("cli_restore_prompt: the prompt left the zero-embed output unchanged")
    result = dict(
        tower_file_bytes=tower_bytes, write_towers_s=t1 - t0, convert_s=t2 - t1,
        load_s=seen["load_s"], **split, caption=caption,
        pixels_differing_from_zero_embeds=int(
            (np.abs(got.astype(np.int16) - zero).max(axis=2) > 0).sum()),
        identical_to_in_memory=True, launches=counts, launches_as_planned=True)
    print("cli_restore_prompt", json.dumps(result), flush=True)


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


def check_nf4(torch, ms_checked=None):
    """The NF4 kernel against its plain version at the captioner's shapes,
    for each M of `ms_checked` (default NF4_M and the caption's prefill M).
    The kernel streams each weight once per call, as the decode path does
    (280 different weights per token): its timed launches cycle through
    copies of the weight that together exceed the 50 MB L2. The kernel and
    the bf16 yardstick are timed from CUDA graphs (device time), the plain
    version from a loop of calls. A row is `ok` when it is `in_tol` (within
    tolerance, finite), has the same bits on two calls and was counted on
    its route (`route` is None for a port that counts no routes, as
    `faithdiff_tpu_torch/scripts/bench_nf4_decode.py` may time)."""
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops.nf4_matmul import nf4_matmul_kernel, nf4_matmul_reference
    from faithdiff_tpu_torch.utils.quantize import dequantize_nf4, quantize_nf4

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    if ms_checked is None:
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
            _build.launches.clear()
            out = nf4_matmul_kernel(x, q)
            route = next((r for r in ("nf4_gemv", "nf4_gemm") if _build.launches[r]), None)
            same_bits = bool(torch.equal(out, nf4_matmul_kernel(x, q)))
            torch.cuda.synchronize()
            ref = nf4_matmul_reference(x, q)
            err = (out.float() - ref.float()).abs()
            # both round each decoded weight to bf16 once and multiply it
            # exactly; the fp32 sums run in another order, which can move
            # the one bf16 rounding of the output by a step (2^-8 relative)
            tol = 1e-2 * (1 + ref.float().abs())
            in_tol = bool((err <= tol).all()) and bool(torch.isfinite(out).all())
            ok = (in_tol and same_bits
                  and route == ("nf4_gemv" if m <= NF4_GEMV_MAX_M else "nf4_gemm"))
            turn = iter(range(1 << 30))

            def cold():
                return nf4_matmul_kernel(x, copies[next(turn) % len(copies)])

            b_ms, b_by = bound(2 * m * in_f * out_f,
                               weight_bytes + m * in_f * 2 + m * out_f * 2,
                               PEAK_BF16_FLOPS)
            ms = graph_ms(torch, cold)
            row = dict(m=m, in_f=in_f, out_f=out_f, route=route,
                       max_abs_err=float(err.max()), tol="1e-2*(1+|ref|)", in_tol=in_tol,
                       ok=ok,
                       same_bits=same_bits, ms=ms, ms_over_bound=ms / b_ms,
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
    prefill route, M = 24) and one-row logits (the decode route)."""
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
        for e, p, route in ((emb, pos, "nf4_gemm"), (emb[:1, :1], pos[:1, :1], "nf4_gemv")):
            _build.launches.clear()
            ref, _ = cpu(e, p)
            got, _ = card(e.cuda().bfloat16(), p.cuda())
            torch.cuda.synchronize()
            n = 7 * cfg.num_hidden_layers
            if dict(_build.launches) != {"nf4_matmul": n, route: n}:
                fail(f"tiny captioner: {dict(_build.launches)} launches, expected "
                     f"{n} on {route}")
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
                "nf4_matmul": 7 * PREFILL_LAYERS, "nf4_gemm": 7 * PREFILL_LAYERS}
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


def run_caption(torch, quant: str = "nf4"):
    """The captioner's main path: build_caption_agent() at full width (13B
    LLaMA, `quant` "nf4" or "int8", ViT-L/14-336), one caption_batch of two
    images. nf4: 280 NF4 launches a forward, on the prefill route for the
    prefill and the decode route after it; int8 (plain torch, as XLA ran
    the JAX package's int8 matmul): no counted launch at all."""
    import numpy as np

    from faithdiff_tpu_torch.captioner import (CLIPVisionConfig, LlamaConfig,
                                               build_caption_agent)
    from faithdiff_tpu_torch.ops import _build

    tok = WordTokenizer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agent = build_caption_agent(tok, LlamaConfig(quant=quant), CLIPVisionConfig(),
                                dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    label = "caption" if quant == "nf4" else f"caption_{quant}"
    print(f"{label}: built LLaVA-1.5-13B {quant} + ViT-L/14-336 in {build_s:.1f} s "
          f"(init + quantise on the card), {weights_gib:.2f} GiB", flush=True)
    if (agent.temperature, agent.top_p, agent.max_new_tokens) != (0.2, 0.7, 512):
        fail("caption agent defaults changed")
    agent.max_new_tokens = CAPTION_NEW_TOKENS

    calls, finite = [], []

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    first, last = [], []

    def lm_pre(module, args, kwargs):
        calls.append([record(), None, args[0].shape[1], args[0].shape[0],
                      dict(_build.launches)])
        last[:] = [args, kwargs]
        if not first:
            first[:] = [args, kwargs]

    def lm_post(module, args, out):
        calls[-1][1] = record()
        before = calls[-1][4]
        # the launches of this forward, by counter
        calls[-1][4] = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                        if v != before.get(k, 0)}
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
    if quant == "nf4":
        if counts != {"nf4_matmul": NF4_PER_FORWARD * n_fwd, "nf4_gemm": NF4_PER_FORWARD,
                      "nf4_gemv": NF4_PER_FORWARD * (n_fwd - 1)}:
            fail(f"launch counts {counts}, expected nf4_matmul = {NF4_PER_FORWARD} x "
                 f"{n_fwd}, nf4_gemm {NF4_PER_FORWARD} (prefill), the rest nf4_gemv")
        check_forward_routes(calls, NF4_PER_FORWARD, label)
    elif counts:
        fail(f"{label}: launch counts {counts}, expected none (no NF4 projection; "
             f"the prompt is under the flash gate)")
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
    print(label, json.dumps(result), flush=True)
    for c in captions:
        print(f"  caption ({len(c)} chars): {c[:100]!r}", flush=True)
    # the prefill and the last decode step once more (their cache slots are
    # rewritten in place with the same values)
    if quant == "nf4":
        profile_call(torch, "profile_prefill", agent.llama, *first)
        profile_call(torch, "profile_decode", agent.llama, *last)
    else:
        profile_call(torch, f"profile_decode_{quant}", agent.llama, *last)
    return counts


def check_forward_routes(calls, per_forward: int, label: str) -> None:
    """Each forward's NF4 launches (the last item of each `calls` row, a
    dict by counter): `per_forward` on the prefill route for the first
    forward and on the decode route for every later one."""
    prefill_routes = {"nf4_matmul": per_forward, "nf4_gemm": per_forward}
    decode_routes = {"nf4_matmul": per_forward, "nf4_gemv": per_forward}
    if calls[0][-1] != prefill_routes or any(c[-1] != decode_routes for c in calls[1:]):
        fail(f"{label}: per-forward launches: prefill {calls[0][-1]}, decode "
             f"{[c[-1] for c in calls[1:] if c[-1] != decode_routes][:3]}")


def llama_vocab_pieces(size: int = 32000):
    """A synthetic LLaMA-sized SentencePiece vocabulary, (piece, score,
    type) in id order: `<unk>` / `<s>` / `</s>` at 0 / 1 / 2, the 256 byte
    pieces, then normal pieces by falling score: the words of the caption
    prompt with `▁` and every prefix of them (so BPE reaches each), single
    characters, then two- and three-letter pieces with and without `▁`."""
    import itertools

    from faithdiff_tpu_torch.captioner.agent import (DEFAULT_QUESTION,
                                                     build_vicuna_prompt)
    from faithdiff_tpu_torch.captioner.llama_tokenizer import (BYTE, CONTROL,
                                                               NORMAL, UNKNOWN)

    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    normal = {}
    for word in re.findall(r"\w+|[^\w\s]", " ".join(build_vicuna_prompt(DEFAULT_QUESTION))):
        for w in ("▁" + word, word):
            for k in range(2, len(w) + 1):
                normal.setdefault(w[:k], None)
    letters = "abcdefghijklmnopqrstuvwxyz"
    for c in "▁" + letters + letters.upper() + "0123456789.,:;!?'\"-()/&":
        normal.setdefault(c, None)
    for n in (2, 3):
        for combo in itertools.product(letters, repeat=n):
            for w in ("".join(combo), "▁" + "".join(combo)):
                normal.setdefault(w, None)
    names = list(normal)[:size - len(pieces)]
    return pieces + [(w, -float(i), NORMAL) for i, w in enumerate(names)]


def write_llava_reference(torch, root: str, layers: int) -> dict:
    """Seeded weights of LLaVA-1.5-13B at full width and `layers` LLaMA
    layers, in the reference's released layout under `root`:
    `llava-v1.5-13b/pytorch_model-0000{1,2}-of-00002.bin` (fp16; the
    embedding and the layers, with transformers' rotary tables, in the
    first, the final norm, `lm_head` and `model.mm_projector.*` in the
    second) with `pytorch_model.bin.index.json`, a 32000-piece
    `tokenizer.model` with `tokenizer_config.json` and
    `special_tokens_map.json`, and `clip-vit-large-patch14-336/
    pytorch_model.bin` (a whole CLIPModel, fp16: the ViT-L/14-336 vision
    tower, a seeded text tower, the projections, `logit_scale`).
    Returns {"llama", "projector", "vision": the written state dicts on the
    card, "sizes": {file: bytes}}."""
    import dataclasses

    from faithdiff_tpu_torch.captioner.clip_vision import (CLIPVisionConfig,
                                                           CLIPVisionTower,
                                                           VisionProjector)
    from faithdiff_tpu_torch.captioner.llama import LlamaConfig, LlamaForCausalLM
    from faithdiff_tpu_torch.captioner.llama_tokenizer import save_sentencepiece_model
    from faithdiff_tpu_torch.config import CLIPTextConfig
    from faithdiff_tpu_torch.models.clip_text import CLIPTextTower
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    cfg = dataclasses.replace(LlamaConfig.llava_13b(), num_hidden_layers=layers)
    vcfg = CLIPVisionConfig()
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.device("cuda"):
        llama = LlamaForCausalLM(cfg, dtype=torch.float16)
        projector = VisionProjector(cfg.hidden_size, vcfg.hidden_size, dtype=torch.float16)
        vision = CLIPVisionTower(vcfg, dtype=torch.float16)
        text = CLIPTextTower(dataclasses.replace(CLIPTextConfig(), projection_dim=768),
                             dtype=torch.float16)
    written = {}
    for name, model in (("llama", llama), ("projector", projector), ("vision", vision),
                        ("text", text)):
        random_init_(model, gen)
        written[name] = {k: v.half() for k, v in model.state_dict().items()}
        del model
    del llama, projector, vision, text
    llava = os.path.join(root, "llava-v1.5-13b")
    os.makedirs(llava)
    head = cfg.hidden_size // cfg.num_attention_heads
    inv_freq = 1.0 / 10000 ** (torch.arange(0, head, 2, dtype=torch.float32) / head)
    first = {k: v for k, v in written["llama"].items() if k.startswith("model.layers.")
             or k == "model.embed_tokens.weight"}
    first.update({f"model.layers.{i}.self_attn.rotary_emb.inv_freq": inv_freq
                  for i in range(layers)})
    second = {k: v for k, v in written["llama"].items() if k not in first}
    second.update({f"model.mm_projector.{k}": v for k, v in written["projector"].items()})
    shards = {"pytorch_model-00001-of-00002.bin": first,
              "pytorch_model-00002-of-00002.bin": second}
    for name, sd in shards.items():
        torch.save({k: v.cpu() for k, v in sd.items()}, os.path.join(llava, name))
    with open(os.path.join(llava, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: name for name, sd in shards.items()
                                                  for k in sd}}, f)
    save_sentencepiece_model(os.path.join(llava, "tokenizer.model"), llama_vocab_pieces())
    with open(os.path.join(llava, "tokenizer_config.json"), "w") as f:
        json.dump({"add_bos_token": True, "add_eos_token": False, "legacy": False,
                   "clean_up_tokenization_spaces": False, "model_max_length": 2048,
                   "tokenizer_class": "LlamaTokenizer"}, f)
    with open(os.path.join(llava, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<unk>"}, f)
    clip_dir = os.path.join(root, "clip-vit-large-patch14-336")
    os.makedirs(clip_dir)
    clip = dict(written["vision"])
    clip.update(written.pop("text"))
    d = vcfg.hidden_size
    clip.update({
        "vision_model.post_layernorm.weight": torch.ones(d, dtype=torch.float16),
        "vision_model.post_layernorm.bias": torch.zeros(d, dtype=torch.float16),
        "vision_model.embeddings.position_ids": torch.arange(vcfg.num_patches + 1)[None],
        "text_model.embeddings.position_ids": torch.arange(77)[None],
        "visual_projection.weight": torch.randn((768, d), generator=gen, device="cuda",
                                                dtype=torch.float16) * d ** -0.5,
        "logit_scale": torch.tensor(4.6052)})
    torch.save({k: v.cpu() for k, v in clip.items()},
               os.path.join(clip_dir, "pytorch_model.bin"))
    sizes = {os.path.relpath(os.path.join(dp, f), root):
             os.path.getsize(os.path.join(dp, f))
             for dp, _, files in os.walk(root) for f in files}
    return dict(written, sizes=sizes)


class ForwardWatch:
    """Forward hooks on a captioner's LLaMA: each forward's rows (sequence
    length, batch) and the counted launches it made."""

    def __init__(self, llama):
        from faithdiff_tpu_torch.ops import _build

        self.calls, self._build = [], _build
        self.handles = [llama.register_forward_pre_hook(self._pre),
                        llama.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self.calls.append([args[0].shape[1], args[0].shape[0],
                           dict(self._build.launches)])

    def _post(self, module, args, out):
        before = self.calls[-1][-1]
        self.calls[-1][-1] = {k: v - before.get(k, 0)
                              for k, v in self._build.launches.items()
                              if v != before.get(k, 0)}

    def remove(self):
        for h in self.handles:
            h.remove()


def run_cli_caption(torch, root: str) -> dict:
    """`cli_caption`: seeded LLaVA-1.5-13B weights at full width and
    CLI_CAPTION_LAYERS layers (a cut for disk space) written in the
    reference's layout, converted by `convert_cli --llava --clip_vision`,
    then `cli.main(["caption", ...])` on two seeded PNGs (int8, the CLI's
    default): the buffers it loads equal `quantize_llama_params(..., "int8")`
    of the written weights, each JSON caption equals the in-memory agent's
    on the same weights and tokenizer (one image a call, seed 0), a second
    call skips both images and `--use_bsrnet` gives the same JSON. Then
    `from_checkpoint(load_4bit=True)` on the same directory: its buffers
    equal the "nf4" quantisation, and its caption of one image launches the
    NF4 kernel 7 x CLI_CAPTION_LAYERS times a forward, on the prefill route
    for the prefill and the decode route after it."""
    import dataclasses
    import io

    import numpy as np

    from faithdiff_tpu_torch import cli
    from faithdiff_tpu_torch.captioner import agent as agent_mod
    from faithdiff_tpu_torch.captioner.clip_vision import (CLIPVisionConfig,
                                                           CLIPVisionTower,
                                                           VisionProjector)
    from faithdiff_tpu_torch.captioner.llama import (LlamaConfig, LlamaForCausalLM,
                                                     quantize_llama_params)
    from faithdiff_tpu_torch.captioner.llama_tokenizer import LlamaTokenizer
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.utils import convert_cli
    from faithdiff_tpu_torch.utils.png import read_png, write_png

    free_gb = shutil.disk_usage(os.path.dirname(root)).free / 1e9
    print(f"cli_caption: {free_gb:.1f} GB free beside {root}; the reference files "
          "take ~6.6 GB and the converted copy as much again", flush=True)
    cfg = dataclasses.replace(LlamaConfig.llava_13b(), num_hidden_layers=CLI_CAPTION_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = write_llava_reference(torch, root, CLI_CAPTION_LAYERS)
    t1 = time.perf_counter()
    out_dir = os.path.join(root, "converted")
    convert_cli.main(["--llava", os.path.join(root, "llava-v1.5-13b"),
                      "--clip_vision", os.path.join(root, "clip-vit-large-patch14-336",
                                                    "pytorch_model.bin"),
                      "--out_dir", out_dir])
    t2 = time.perf_counter()
    cap_dir = os.path.join(out_dir, "captioner")

    rng = np.random.default_rng(13)
    img_dir = os.path.join(root, "in")
    os.makedirs(img_dir)
    names = [f"photo_{i}" for i in range(len(CAPTION_IMAGES))]
    for name, hw in zip(names, CAPTION_IMAGES):
        write_png(os.path.join(img_dir, f"{name}.png"),
                  rng.integers(0, 256, hw + (3,), dtype=np.uint8))

    load = agent_mod.CaptionAgent.from_checkpoint
    loaded = []

    def watched(ckpt_dir, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        agent = load(ckpt_dir, llama_config=cfg, **kw)
        torch.cuda.synchronize()
        loaded.append((agent, time.perf_counter() - t))
        return agent

    def caption_cli(save_dir, *extra):
        out = io.StringIO()
        agent_mod.CaptionAgent.from_checkpoint = staticmethod(watched)
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["caption", "--img_dir", img_dir, "--save_dir", save_dir,
                               "--captioner_dir", cap_dir, *extra])
        finally:
            agent_mod.CaptionAgent.from_checkpoint = staticmethod(load)
        print(out.getvalue(), end="", flush=True)
        if rc != 0:
            fail(f"cli caption returned {rc}")
        agent, load_s = loaded.pop()
        captions = {}
        for name in names:
            path = os.path.join(save_dir, f"{name}.json")
            with open(path) as f:
                captions[name] = json.load(f)
        return agent, load_s, out.getvalue(), captions

    _build.launches.clear()
    cli_agent, load_s, log, captions = caption_cli(os.path.join(root, "caps"))
    caption_s = [float(x) for x in re.findall(r"caption_s=([0-9.]+)", log)]
    if len(caption_s) != len(names) or _build.launches:
        fail(f"cli_caption: {len(caption_s)} captions, launches {dict(_build.launches)}")

    # the buffers the CLI loaded are the int8 quantisation of the written weights
    def check_buffers(agent, mode):
        want = quantize_llama_params(ref["llama"], mode)
        got = agent.llama.state_dict()
        if sorted(got) != sorted(want):
            fail(f"cli_caption: {mode} keys differ: {sorted(set(got) ^ set(want))[:4]}")
        bad = [k for k in want if not torch.equal(got[k], want[k].to(got[k].dtype))]
        for name, module in (("projector", agent.projector), ("vision", agent.vision)):
            sd = module.state_dict()
            bad += [f"{name}.{k}" for k, v in ref[name].items()
                    if not torch.equal(sd[k], v.to(sd[k].dtype))]
        if bad:
            fail(f"cli_caption: {len(bad)} {mode} buffers differ, e.g. {bad[:3]}")
        return len(want)

    n_int8 = check_buffers(cli_agent, "int8")
    del cli_agent
    # the in-memory agent on the same weights and tokenizer
    with torch.device("cuda"):
        llama = LlamaForCausalLM(dataclasses.replace(cfg, quant="int8"), dtype=torch.bfloat16)
        vision = CLIPVisionTower(CLIPVisionConfig(), dtype=torch.bfloat16)
        projector = VisionProjector(cfg.hidden_size, CLIPVisionConfig().hidden_size,
                                    dtype=torch.bfloat16)
    llama.load_state_dict(quantize_llama_params(ref["llama"], "int8"))
    vision.load_state_dict(ref["vision"])
    projector.load_state_dict(ref["projector"])
    for m in (llama, vision, projector):
        m.eval().requires_grad_(False)
    agent = agent_mod.CaptionAgent(llama=llama, vision=vision, projector=projector,
                                   tokenizer=LlamaTokenizer.from_pretrained(
                                       os.path.join(root, "llava-v1.5-13b")))
    in_memory_s = []
    for name in names:
        t = time.perf_counter()
        want = agent.caption(read_png(os.path.join(img_dir, f"{name}.png")), seed=0)
        in_memory_s.append(time.perf_counter() - t)
        if captions[name] != {"caption": want}:
            fail(f"cli_caption: {name}: the CLI wrote {captions[name]!r}, the in-memory "
                 f"agent gave {want!r}")
    del agent, llama, vision, projector
    torch.cuda.empty_cache()

    _, _, log, again = caption_cli(os.path.join(root, "caps"))
    if log.count("skip ") != len(names) or again != captions:
        fail(f"cli_caption: a second call did not skip both images: {log!r}")
    _, _, log, bsr = caption_cli(os.path.join(root, "caps_bsrnet"), "--use_bsrnet")
    if "--use_bsrnet is not applied" not in log or bsr != captions:
        fail("cli_caption: --use_bsrnet changed the captions or gave no warning")
    torch.cuda.empty_cache()

    # the same directory at load_4bit: the NF4 kernel on both routes
    t = time.perf_counter()
    nf4 = agent_mod.CaptionAgent.from_checkpoint(cap_dir, load_4bit=True, llama_config=cfg)
    torch.cuda.synchronize()
    nf4_load_s = time.perf_counter() - t
    n_nf4 = check_buffers(nf4, "nf4")
    watch = ForwardWatch(nf4.llama)
    _build.launches.clear()
    t = time.perf_counter()
    nf4_caption = nf4.caption(read_png(os.path.join(img_dir, f"{names[0]}.png")), seed=0)
    torch.cuda.synchronize()
    nf4_caption_s = time.perf_counter() - t
    watch.remove()
    per_forward = 7 * CLI_CAPTION_LAYERS
    n_fwd = len(watch.calls)
    nf4_launches = dict(_build.launches)
    if nf4_launches != {"nf4_matmul": per_forward * n_fwd, "nf4_gemm": per_forward,
                        "nf4_gemv": per_forward * (n_fwd - 1)}:
        fail(f"cli_caption: nf4 launches {nf4_launches} over {n_fwd} forwards")
    check_forward_routes(watch.calls, per_forward, "cli_caption nf4")
    del nf4, watch
    result = dict(
        free_disk_gb=free_gb, layers=CLI_CAPTION_LAYERS, file_bytes=ref["sizes"],
        write_weights_s=t1 - t0, convert_s=t2 - t1, load_s=load_s,
        caption_s=caption_s, in_memory_caption_s=in_memory_s,
        buffers_checked_int8=n_int8, identical_to_in_memory=True, second_call_skipped=True,
        use_bsrnet_same=True, nf4_load_s=nf4_load_s, buffers_checked_nf4=n_nf4,
        nf4_caption_s=nf4_caption_s, nf4_forwards=n_fwd,
        nf4_launches_per_forward=per_forward, nf4_launches=nf4_launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        caption_chars=[len(c["caption"]) for c in captions.values()])
    print("cli_caption", json.dumps(result), flush=True)
    for name in names:
        print(f"  {name}: {captions[name]['caption'][:100]!r}", flush=True)
    print(f"  nf4 {names[0]}: {nf4_caption[:100]!r}", flush=True)
    return result


def check_bsrnet(torch) -> dict:
    """`bsrnet`: the full-width RRDBNet (nf 64, nb 23, gc 32, x4) in bf16 on
    the card, seeded; `deg_remove` of a BSRNET_PIXELS image in [0, 1]
    (512 px tiles, 16 px halo): the output shape, finite values, the tile
    count, and one 64x64 crop in bf16 on the card against fp32 on the CPU."""
    import numpy as np

    from faithdiff_tpu_torch.models.bsrnet import RRDBNet, deg_remove
    from faithdiff_tpu_torch.pipelines.factory import random_init_

    with torch.device("cuda"):
        model = RRDBNet(dtype=torch.bfloat16).eval().requires_grad_(False)
    random_init_(model, torch.Generator(device="cuda").manual_seed(14))
    h, w = BSRNET_PIXELS
    rng = np.random.default_rng(15)
    img = torch.from_numpy(rng.integers(0, 256, (1, 3, h, w), dtype=np.uint8)).cuda() / 255.0
    tiles = []
    hook = model.register_forward_hook(lambda m, a, o: tiles.append(tuple(a[0].shape)))
    deg_remove(model, img[:, :, :600, :600])                     # warm-up: 2 x 2 tiles
    tiles.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = deg_remove(model, img)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    hook.remove()
    if tuple(out.shape) != (1, 3, 4 * h, 4 * w) or not bool(torch.isfinite(out).all()):
        fail(f"bsrnet: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    if len(tiles) != BSRNET_TILES:
        fail(f"bsrnet: {len(tiles)} tiles, expected {BSRNET_TILES}")
    crop = img[:, :, :64, :64]
    cpu = RRDBNet().eval().requires_grad_(False)
    cpu.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        got = model(crop.bfloat16()).float().cpu()
        want = cpu(crop.cpu())
    err = (got - want).abs()
    max_ref, mean_ref = float(want.abs().max()), float(want.abs().mean())
    ok = (float(err.max()) <= BSRNET_TOL * max_ref
          and float(err.mean()) <= BSRNET_MEAN_TOL * mean_ref)
    result = dict(pixels=[h, w], out=list(out.shape), tiles=len(tiles),
                  tile_shapes=sorted(set(tiles)), wall_s=wall_s,
                  ms_per_tile=start.elapsed_time(end) / len(tiles),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  crop_max_abs_err=float(err.max()), crop_mean_abs_err=float(err.mean()),
                  crop_max_ref=max_ref, crop_mean_ref=mean_ref,
                  tol=f"max {BSRNET_TOL} x max|ref|, mean {BSRNET_MEAN_TOL} x mean|ref|",
                  ok=ok)
    print("bsrnet", json.dumps(result), flush=True)
    if not ok:
        fail(f"bsrnet: bf16 crop off fp32 by {float(err.max())} (max), "
             f"{float(err.mean())} (mean)")
    del model, out, img
    torch.cuda.empty_cache()
    return result


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
    from faithdiff_tpu_torch import cli
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

    with phase("kernel_checks"):
        attn = check_attention(torch)
        packed = check_attention_packed(torch)
        ragged = check_attention_ragged(torch)
        variants = check_attention_variants(torch)
        fused, stats, apply_ = check_group_norm(torch)
    bad = [r for r in attn + packed + ragged + variants + fused + stats + apply_
           if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks out of tolerance: {bad}")

    with phase("restore"):
        pipe = build_restore(torch)
        counts, (args, kwargs), _ = run_restore(torch, pipe, packed=False)
        with attention_path(False):
            profile_call(torch, "profile", pipe.unet, args, kwargs)
    with phase("restore_packed"):
        packed_counts, (args, kwargs), _ = run_restore(torch, pipe, packed=True)
        with attention_path(True):
            profile_call(torch, "profile_packed", pipe.unet, args, kwargs)
        check_path_parity(torch, pipe.unet, args, kwargs)
    del args, kwargs
    if not all(counts.get(k) for k in ("group_norm_fused", "group_norm_stats",
                                       "group_norm_apply")):
        fail(f"restore did not launch every GroupNorm kernel: {counts}")
    # the reference-layout weight files and the converted copy live beside
    # the built kernels, and go whether the CLI phases pass or fail
    root = os.path.join(_build.BUILD_DIR, f"cli_weights_{os.getpid()}")
    os.makedirs(root, exist_ok=True)
    try:
        with phase("cli_restore"):
            ckpt = run_cli_restore(torch, pipe, root)
        with phase("cli_restore_tiled"):
            run_cli_restore_tiled(torch, root, ckpt)
        with phase("cli_restore_prompt"):
            run_cli_restore_prompt(torch, pipe, root, ckpt)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with phase("restore_large"):
        _, (args, kwargs), first = run_restore(torch, pipe, packed=False,
                                               pixels=LARGE_PIXELS,
                                               label="restore_large")
    if args[0].shape[0] != 2 * LARGE_TILES:
        fail(f"restore_large: UNet batch {args[0].shape[0]}, expected "
             f"{2 * LARGE_TILES} ({LARGE_TILES} tiles)")
    with phase("chunk_parity"):
        check_chunk_parity(torch, pipe.unet, *first, cli.TILE_CHUNK)
    del first
    with phase("tile_chunk_sweep"):
        run_tile_chunk_sweep(torch, pipe.unet, args, kwargs)
    del args, kwargs
    # the canvases of restore_4k go whether the phase passes or fails
    ckpt_dir = os.path.join(_build.BUILD_DIR, f"restore_4k_{os.getpid()}")
    try:
        with phase("restore_4k"):
            run_restore_4k(torch, pipe, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    tok_root = os.path.join(_build.BUILD_DIR, f"tokenizer_{os.getpid()}")
    try:
        with phase("text_towers"):
            check_text_towers(torch, write_tokenizer_dirs(tok_root))
    finally:
        shutil.rmtree(tok_root, ignore_errors=True)
    with phase("vae_chunk_trap"):
        check_vae_chunk_trap(torch)
    with phase("bench"):
        bench_counts = run_bench(torch)

    with phase("nf4"):
        nf4 = check_nf4(torch)
    bad = [r for r in nf4 if not r["ok"]]
    if bad:
        fail(f"{len(bad)} NF4 kernel checks out of tolerance: {bad}")
    with phase("caption"):
        check_caption_small(torch)
        check_llama_prefill(torch)
        caption_counts = run_caption(torch)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("caption_int8"):
        run_caption(torch, "int8")
    gc.collect()
    torch.cuda.empty_cache()
    # the reference-layout captioner files and their converted copy go
    # whether the phase passes or fails
    cap_root = os.path.join(_build.BUILD_DIR, f"caption_weights_{os.getpid()}")
    try:
        with phase("cli_caption"):
            run_cli_caption(torch, cap_root)
    finally:
        shutil.rmtree(cap_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("bsrnet"):
        check_bsrnet(torch)

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
