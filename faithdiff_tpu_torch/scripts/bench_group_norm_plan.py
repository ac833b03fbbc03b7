"""The single-pass GroupNorm kernel under other launch plans, on one CUDA
card.

    python -m faithdiff_tpu_torch.scripts.bench_group_norm_plan

For each setting of the planner's constants (`ops.groupnorm`: the most
bytes a block holds, the largest cluster) and each shape, it prints one JSON line: the plan's cluster size and
blocks, the device time of one call from CUDA-graph replays, that time
over the byte bound, and the two-pass pair's time at the same shape.
Shapes: the UNet's ResNet / Transformer2D GroupNorms at batch 4 and the
15-tile restore's [30, 2560, 32, 32] and [30, 960, 128, 128], bf16 with
add and SiLU. Raises without a CUDA card.
"""
from __future__ import annotations

import json

import torch

from faithdiff_tpu_torch.ops import groupnorm as gn

SHAPES = ((4, 320, 128, 128), (4, 640, 64, 64), (4, 1280, 32, 32),
          (30, 2560, 32, 32), (30, 960, 128, 128))
# (FUSED_SLICE_BYTES, FUSED_MAX_CLUSTER); the first is the planner's default
SETTINGS = ((64 * 1024, 16), (120 * 1024, 8), (32 * 1024, 16))
PEAK_BYTES = 3.35e12            # H100 SXM HBM3


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device ms of one call of `fn`, from CUDA events around replays
    of a CUDA graph of `launches` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays / launches


def main() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_group_norm_plan needs a CUDA card")
    defaults = (gn.FUSED_SLICE_BYTES, gn.FUSED_MAX_CLUSTER)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    try:
        for shape in SHAPES:
            b, c = shape[:2]
            x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
            scale = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).bfloat16()
            bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).bfloat16()
            add = torch.randn((b, c), generator=gen, device="cuda").bfloat16()
            bound_ms = (2 * x.numel() * 2 + add.numel() * 2) / PEAK_BYTES * 1e3
            pair_ms = None
            for setting in SETTINGS:
                gn.FUSED_SLICE_BYTES, gn.FUSED_MAX_CLUSTER = setting
                launch = gn.GroupNormLaunch(x, scale, bias, 32, 1e-5, "silu", add)
                if pair_ms is None:
                    launch.stats()
                    pair_ms = graph_ms(launch.two_pass)
                p = launch.plan
                if not p.cluster:
                    continue
                ms = graph_ms(launch.fused)
                row = dict(shape=list(shape), slice_bytes=setting[0],
                           max_cluster=setting[1],
                           cluster=p.cluster, blocks=p.fused_grid,
                           slice_kib=p.slice_len * 2 / 1024, ms=ms,
                           bound_ms=bound_ms, ms_over_bound=ms / bound_ms,
                           two_pass_ms=pair_ms)
                print("group_norm_plan", json.dumps(row), flush=True)
                rows.append(row)
            del x, launch
            torch.cuda.empty_cache()
    finally:
        gn.FUSED_SLICE_BYTES, gn.FUSED_MAX_CLUSTER = defaults
    return rows


if __name__ == "__main__":
    main()
