"""Reading `torch.profiler` Chrome traces of a traced request.

A trace run traces two more requests after the window, both the same
work as a timed one:

- the device trace: CUDA activity only, which costs the host less than
  tracing its operations too (it still pays CUPTI's cost a launch). It gives the kernels, the device's busy time (the
  union of kernel intervals), device time by kernel class (lower-cased
  name fragments, first match) and the idle gap before each kernel; the
  request's host wall time, synchronised, is the traced window.
- the host trace: host and device, with the harness's `bench.image` range
  around the request and a `bench.unet` range around each UNet call. It
  gives the host operation that launched each kernel, and the kernels
  launched from inside the UNet.

Both requests launch the same kernels in the same order (a few more or
fewer at the edges), so the two kernel sequences are aligned by name and
the gap before each kernel of the device trace is charged to the host
operation that launched the same kernel in the host trace.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# lower-cased kernel-name fragments -> class, first match wins (cuDNN's
# convolution kernels carry "gemm" in their names too)
KERNEL_CLASSES = (("flash_bsnd_fwd_kernel", "packed flash attention"),
                  ("flash_wide", "wide flash attention"),
                  ("flash", "flash attention"),
                  ("fmha", "flash attention"),
                  ("nf4_ge", "NF4 dequant-matmul"),
                  ("::gn_", "GroupNorm"), ("group_norm", "GroupNorm"),
                  ("groupnorm", "GroupNorm"),
                  ("fprop", "convolution"), ("conv", "convolution"),
                  ("nchwtonhwc", "cuDNN layout transpose"),
                  ("nhwctonchw", "cuDNN layout transpose"),
                  ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
                  ("softmax", "softmax"), ("reduce", "reduction"),
                  ("copy", "copy / dtype cast"), ("elementwise", "elementwise"))

ATTENTION_CLASSES = ("packed flash attention", "wide flash attention",
                     "flash attention")
GROUP_NORM_CLASSES = ("GroupNorm",)
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation")
OUTSIDE = "before the first or after the last kernel"


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for frag, c in KERNEL_CLASSES if frag in low), "other")


def union_seconds(spans: Sequence[Tuple[float, float]]) -> float:
    """Seconds covered by at least one (start_us, end_us) interval."""
    total, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total / 1e6


def _kernels(events: List[dict]) -> List[dict]:
    ks = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    ks.sort(key=lambda e: e["ts"])
    return ks


def _innermost(starts: List[float], ops: List[tuple], t: float, limit: int = 4000) -> str:
    """Name of the latest-starting host op that covers time `t`."""
    i = bisect.bisect_right(starts, t) - 1
    stop = max(-1, i - limit)
    while i > stop:
        s, e, name = ops[i]
        if e >= t:
            return name
        i -= 1
    return "host"


def device_summary(events: List[dict], wall_s: float) -> Dict:
    """Busy time, classes and per-kernel gaps of a device trace."""
    ks = _kernels(events)
    if not ks:
        return {}
    by_class: Dict[str, float] = defaultdict(float)
    gaps, end = [], ks[0]["ts"]
    for e in ks:
        by_class[kernel_class(e["name"])] += e["dur"] / 1e6
        gaps.append(max(0.0, e["ts"] - end) / 1e6)
        end = max(end, e["ts"] + e["dur"])
    busy = union_seconds([(e["ts"], e["ts"] + e["dur"]) for e in ks])
    return dict(window_s=wall_s, busy_s=busy, span_s=(end - ks[0]["ts"]) / 1e6,
                kernels=len(ks), gaps=gaps, kernel_names=[e["name"] for e in ks],
                by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
                attention_s=sum(by_class.get(c, 0.0) for c in ATTENTION_CLASSES),
                group_norm_s=sum(by_class.get(c, 0.0) for c in GROUP_NORM_CLASSES))


def host_summary(events: List[dict], window: str = "bench.image",
                 unet: str = "bench.unet") -> Dict:
    """The launching host op of each kernel of a host trace of one request
    (which has its `window` range), and the kernels launched inside `unet`
    ranges."""
    ranges = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    win = [e for e in ranges if e.get("name") == window]
    if not win:
        return {}
    ks = _kernels(events)        # the trace holds the one request
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in _HOST_CATS and "dur" in e and e.get("name") != window)
    starts = [h[0] for h in host]
    unet_ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges if e.get("name") == unet)
    unet_starts = [r[0] for r in unet_ranges]
    names, in_unet = [], 0
    for e in ks:
        t = launches.get(e.get("args", {}).get("correlation"))
        names.append("host" if t is None else _innermost(starts, host, t))
        if t is not None:
            i = bisect.bisect_right(unet_starts, t) - 1
            in_unet += i >= 0 and unet_ranges[i][1] >= t
    return dict(kernels=len(ks), kernel_names=[e["name"] for e in ks], launch_ops=names,
                unet_calls=len(unet_ranges), unet_launches=in_unet)


def align(device_names: List[str], host: Dict, lookahead: int = 64) -> List[str]:
    """The launching host op of each device-trace kernel: the next kernel of
    the same name in the host trace, looking at most `lookahead` kernels
    past one the device trace lacks; "unattributed" where none is found."""
    names, ops = host["kernel_names"], host["launch_ops"]
    out, j = [], 0
    for name in device_names:
        k = j
        while k < len(names) and k - j < lookahead and names[k] != name:
            k += 1
        if k < len(names) and names[k] == name:
            out.append(ops[k])
            j = k + 1
        else:
            out.append("unattributed")
    return out


def summarise(device: Dict, host: Optional[Dict]) -> Dict:
    """The numbers the per-layer readers and the breakdown take: the
    device trace's, the host trace's UNet launches, and the device trace's
    idle gaps by the host op that launched the kernel ending each gap."""
    if not device:
        return {}
    out = {k: v for k, v in device.items() if k not in ("gaps", "kernel_names")}
    gaps: Dict[str, float] = defaultdict(float)
    ops = (align(device["kernel_names"], host) if host
           else ["unattributed"] * device["kernels"])
    for op, g in zip(ops, device["gaps"]):
        if g > 0:
            gaps[op] += g
    gaps[OUTSIDE] += max(0.0, device["window_s"] - device["span_s"])
    out["idle_gaps"] = dict(sorted(gaps.items(), key=lambda kv: -kv[1]))
    if host:
        out.update(unet_calls=host["unet_calls"], unet_launches=host["unet_launches"],
                   host_kernels=host["kernels"])
    return out


def load(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
