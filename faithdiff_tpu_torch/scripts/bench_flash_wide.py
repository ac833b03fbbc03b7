"""Times the wide head-dim bf16 flash kernel (`csrc/flash_attention_wide.cu`)
of one checkout of the port, or with `--dtype float32` the fp32 flash
kernel (`csrc/flash_attention_f32.cu`), so that two versions of a kernel
can be timed in one run on one card.

    python faithdiff_tpu_torch/scripts/bench_flash_wide.py [--tree DIR]
        [--label NAME] [--dtype float32]

`faithdiff_tpu_torch` is imported from `--tree DIR` (default: this
checkout), say an older commit unpacked with `git archive`; the timing
helpers come from this checkout's `chip_smoke.py`. Run the script as a
file, not with `-m`. One `flash_wide` line a shape: the VAE's
[1, 1, 1024, 512], [1, 1, 1024, 256], [2, 4, 2048, 256], the 1024 px
tile's [1, 1, 16384, 512] and the packed [1, 1024, 512], each with the
kernel's and SDPA's times from CUDA graphs of 20 calls, the bound at the
card's published bf16 and memory rates, the split plan where the tree has
one (`wide_plan`), whether two calls gave the same bits, and the largest
error against the plain version (`chunked_attention` at 16,384 tokens,
whose time is also given). Exits nonzero without a card, or when a shape
is out of tolerance (1e-2 + 8e-3 |ref|) or differs between two calls.

`--dtype float32` times instead the fp32 kernel's rows (F32_SHAPES: the
trainer's d = 64 attentions at a 1024 px tile, the LLaMA's causal d = 128
prefill, the packed layout, and the wide shapes above at fp32), TF32 off,
each beside SDPA in fp32 with the bound at the 3xTF32 rate (495 / 3
TFLOP/s: `chip_smoke.PEAK_TF32X3_FLOPS`), within 2e-5 * max|ref| of the
plain version (`f32_flash` lines; the split plan where the tree has
`f32_plan`).

`--splits N ...` (this checkout only) times instead the short shapes
(SPLIT_SHAPES) with the split count forced to each N (`wide_plan(...,
splits=N)`, rounded to equal tile counts), beside the kernel alone and the
merge alone on the same partials (`flash_wide_split` lines): how
`wide_plan`'s MIN_SPLIT_TILES was chosen.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ([B, H, S, d] or packed [b, s, n*d], heads or None)
SHAPES = [((1, 1, 1024, 512), None), ((1, 1, 1024, 256), None),
          ((2, 4, 2048, 256), None), ((1, 1, 16384, 512), None),
          ((1, 1024, 512), 1)]


# (shape, heads or None, causal): the fp32 kernel's timed rows
F32_SHAPES = [((2, 10, 4096, 64), None, False), ((2, 20, 1024, 64), None, False),
              ((1, 40, 1024, 128), None, True), ((2, 4096, 640), 10, False),
              ((1, 1, 1024, 512), None, False), ((1, 1, 1024, 256), None, False),
              ((2, 4, 2048, 256), None, False), ((1, 1024, 512), 1, False)]


# the VAE's attention at 1, 2 and 4 tiles of 1024 tokens, and d = 256
SPLIT_SHAPES = [(1, 1, 1024, 512), (1, 1, 1024, 256), (4, 1, 1024, 512),
                (1, 1, 2048, 512)]


def split_sweep(smoke, torch, A, counts) -> list:
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in SPLIT_SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        out = torch.empty_like(q)
        strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
        dims = (b, h, s, s, d)
        for n in counts:
            plan = A.wide_plan(b, h, s, s, d, splits=n)
            if rows and rows[-1]["shape"] == list(shape) and rows[-1]["splits"] == plan.splits:
                continue
            fwd = lambda: A._wide_fwd_launch(q, k, v, out, strides, dims, d ** -0.5,  # noqa: E731
                                             False, plan)
            row = dict(shape=list(shape), splits=plan.splits, blocks=plan.blocks,
                       tiles_per_split=plan.tiles_per_split,
                       planned=plan == A.wide_plan(b, h, s, s, d,
                                                   sms=A._sm_count(q.device)))
            if plan.splits == 1:
                row["ms"] = smoke.graph_ms(torch, fwd)
            else:
                parts = fwd()
                merge = lambda: A._wide_merge_launch(*parts, out, strides[9:12], h, s)  # noqa: E731
                both = lambda: A._wide_merge_launch(*fwd(), out, strides[9:12], h, s)  # noqa: E731
                row.update(ms=smoke.graph_ms(torch, both),
                           kernel_ms=smoke.graph_ms(torch, fwd),
                           merge_ms=smoke.graph_ms(torch, merge))
            rows.append(row)
            print("flash_wide_split", json.dumps(row), flush=True)
        del q, k, v, out
    return rows


def bench_shape(smoke, torch, A, shape, heads, causal=False, dtype=None) -> dict:
    import torch.nn.functional as F

    from faithdiff_tpu_torch.utils.profiling import time_ms

    f32 = dtype == torch.float32
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype or torch.bfloat16)
               for _ in range(3))
    if heads is None:
        b, h, s, d = shape
        kernel = lambda: A.flash_attention(q, k, v, d ** -0.5, causal)  # noqa: E731
        views = (q, k, v)
        if s > 4096:
            plain = lambda: A.chunked_attention(q, k, v, d ** -0.5)  # noqa: E731
        else:
            plain = lambda: A.attention_reference(q, k, v, d ** -0.5, causal)  # noqa: E731
    else:
        (b, s, f), h = shape, heads
        d = f // h
        kernel = lambda: A.flash_attention_packed(q, k, v, h, d ** -0.5)  # noqa: E731
        views = tuple(t.view(b, s, h, d).transpose(1, 2) for t in (q, k, v))
        plain = lambda: A.einsum_bsnd(q, k, v, h, d ** -0.5)  # noqa: E731
    out, again = kernel(), kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (out.float() - ref.float()).abs()
    pairs = s * (s + 1) / 2 if causal else s * s
    flops, nbytes = 4 * b * h * d * pairs, 4 * b * h * s * d * q.element_size()
    bound_ms, bound_by = smoke.bound(
        flops, nbytes, smoke.PEAK_TF32X3_FLOPS if f32 else smoke.PEAK_BF16_FLOPS)
    ms = smoke.graph_ms(torch, kernel)
    row = dict(shape=list(shape), heads=heads, causal=causal, ms=ms,
               library_ms=smoke.graph_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       *views, is_causal=causal, scale=d ** -0.5)),
               bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
               ms_over_bound=ms / bound_ms, max_abs_err=float(err.max()),
               in_tol=(float(err.max()) <= 2e-5 * float(ref.abs().max()) if f32 else
                       bool((err <= 1e-2 + 8e-3 * ref.float().abs()).all())),
               same_bits=bool(torch.equal(out, again)))
    if s > 4096:
        row["chunked_ms"] = time_ms(plain, 3, 1)
    plan_fn = getattr(A, "f32_plan" if f32 else "wide_plan", None)
    if plan_fn is not None and (f32 or d > 128):
        plan = plan_fn(b, h, s, s, d, causal, sms=A._sm_count(q.device))
        row.update(splits=plan.splits, blocks=plan.blocks)
    del q, k, v, out, again, ref, err
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--splits", type=int, nargs="+")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    import faithdiff_tpu_torch
    from faithdiff_tpu_torch.ops import _build
    from faithdiff_tpu_torch.ops import attention as A

    if not os.path.abspath(faithdiff_tpu_torch.__file__).startswith(tree + os.sep):
        print(f"bench_flash_wide: imported {faithdiff_tpu_torch.__file__}, not from "
              f"{tree}: run the script as a file", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_flash_wide: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {smoke.card_line()}; tree {args.label}", flush=True)
    _build.build_all()
    source = "flash_attention_f32" if args.dtype == "float32" else "flash_attention_wide"
    smoke.print_ptxas(source, _build.build_log.get(source, ""))
    if args.splits:
        split_sweep(smoke, torch, A, args.splits)
        return 0
    ok = True
    if args.dtype == "float32":
        with smoke.tf32_off(torch):
            for shape, heads, causal in F32_SHAPES:
                row = bench_shape(smoke, torch, A, shape, heads, causal, torch.float32)
                print("f32_flash", json.dumps(dict(row, label=args.label)), flush=True)
                ok = ok and row["in_tol"] and row["same_bits"]
        return 0 if ok else 1
    for shape, heads in SHAPES:
        row = bench_shape(smoke, torch, A, shape, heads)
        print("flash_wide", json.dumps(dict(row, label=args.label)), flush=True)
        ok = ok and row["in_tol"] and row["same_bits"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
