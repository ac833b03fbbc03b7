"""Micro-benchmark of the attention-variant kernel on one CUDA card.

    python -m faithdiff_tpu_torch.scripts.bench_attention_variants

Counterpart of `scripts/bench_attention_variants.py`. Grid: {base e,
scale-fold + base 2} x block_k (`ops.attention_variants.VARIANTS`; 64 q
rows a tile) at the SDXL UNet self-attention shapes (20, 4096, 64) and
(40, 1024, 64), bf16. For each variant it prints the device time of one
call (CUDA events around `iters` calls after a warm-up), the rate, and the
largest difference from the first variant's output. Raises without a CUDA
card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from faithdiff_tpu_torch.ops.attention_variants import (VARIANTS,
                                                        attention_variant)

SHAPES = ((20, 4096, 64), (40, 1024, 64))
BLOCK_Q = 64


def bench(fn, iters: int) -> float:
    """Mean device ms of one call of `fn`."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(iters: int = 30) -> list:
    """Run the grid; returns one dict per (shape, variant)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention_variants needs a CUDA card")
    rng = np.random.default_rng(0)
    rows = []
    for bh, s, d in SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d), np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        flops = 4 * bh * s * s * d
        ref = None
        print(f"== shape bh={bh} s={s} d={d}", flush=True)
        for base2, bk in VARIANTS:
            out = attention_variant(q, k, v, scale, base2, bk).float()
            if ref is None:
                ref = out
            err = float((out - ref).abs().max())
            ms = bench(lambda: attention_variant(q, k, v, scale, base2, bk), iters)
            print(f"base2={int(base2)} bq={BLOCK_Q:5d} bk={bk:5d}: {ms:7.3f} ms  "
                  f"{flops / ms / 1e9:6.1f} TF/s  maxerr={err:.2e}", flush=True)
            rows.append(dict(shape=[bh, s, d], base2=base2, block_k=bk, ms=ms,
                             tflops=flops / ms / 1e9, max_err_vs_first=err))
    return rows


if __name__ == "__main__":
    main()
