"""The program's own spans (`faithdiff_tpu_torch.utils.profiling`) against
the device trace, and the requests that record them.

Three requests of a trace run record the program's spans:

- (A) after the window, before any profiler has run in the process, the
  recorder on (`unprofiled_request`): each span's host and device
  duration (CUDA events) and its counters;
- (B) after the profiled requests of `trace_reader`, the recorder on under
  the device-only profiler (`profiled_requests`): each gap of the device
  trace charged to the innermost span open on the host during it
  (`idle_by_span`), and the busy time of the kernels launched while each
  span was the innermost (`busy_by_span`). A span's host stamps are
  `time.time_ns()`, the clock of the Chrome trace (`baseTimeNanoseconds`
  + 1000 ts), so no conversion. The profiler's cost a launch lengthens
  B's gaps, not its kernels, so a span's idle is read untraced: A's
  device time less B's busy time (`idle_per`);
- (C) with fp8-stored weights only, the recorder on under the host and
  device profiler: the device time of the kernels launched inside the
  program's `fp8_upcast` ranges (`upcast_kernels`), found by the launch's
  correlation as `trace_reader.host_summary` finds them.

The result is the `program` the per-layer readers take (`read_program`):
`setup` (the spans of the set-up, recorded by the caller), `spans` and
`wall_s` (A's), `idle` (B's) and `upcast` (C's). Every function here gives
nothing, without raising, for a program that has no recorder. The
kernels, their launches and their union come from `trace_reader`.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import trace_reader

OUTSIDE = "outside any span"


# ------------------------------------------------------------ span arithmetic
def children(spans: Sequence[dict]) -> Dict[Optional[int], List[dict]]:
    """Each span's children by parent id (None: the roots), in order."""
    out: Dict[Optional[int], List[dict]] = defaultdict(list)
    for s in spans:
        out[s["parent"]].append(s)
    return out


def self_ms(spans: Sequence[dict], key: str = "device_ms") -> Dict[int, float]:
    """A span's duration (`key`) less its children's, by span id."""
    kids = children(spans)
    return {s["id"]: s[key] - sum(c[key] for c in kids.get(s["id"], ())) for s in spans}


def named(spans: Sequence[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def _self_segments(spans: Sequence[dict]) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, name) of the time each span was the innermost open
    one, and of the time outside every root (named OUTSIDE), sorted. Spans
    of one thread nest, so a span's self time is its interval less its
    children's."""
    kids = children(spans)
    segs = []

    def cut(start, end, inner, name):
        t = start
        for c in sorted(inner, key=lambda c: c["start_ns"]):
            if c["start_ns"] > t:
                segs.append((t, c["start_ns"], name))
            t = max(t, c["end_ns"])
        if end > t:
            segs.append((t, end, name))

    for s in spans:
        cut(s["start_ns"], s["end_ns"], kids.get(s["id"], ()), s["name"])
    cut(-(1 << 62), 1 << 62, kids.get(None, ()), OUTSIDE)
    return sorted(segs)


def device_gaps_ns(events: Sequence[dict], base_ns: int) -> List[Tuple[int, int]]:
    """The device trace's idle gaps between its first kernel's start and its
    last kernel's end, as (start_ns, end_ns) on the host's clock."""
    gaps, end = [], None
    for k in trace_reader._kernels(events):
        s, t = k["ts"], k["ts"] + k["dur"]
        if end is not None and s > end:
            gaps.append((base_ns + round(end * 1e3), base_ns + round(s * 1e3)))
        end = t if end is None else max(end, t)
    return gaps


def idle_by_span(spans: Sequence[dict], events: Sequence[dict], base_ns: int) -> dict:
    """Each gap of the device trace split over the span innermost on the
    host during it: `idle_ms` by span name (OUTSIDE for none), the
    `gap_ms` they sum to, and `count`, the spans of each name."""
    gaps = device_gaps_ns(events, base_ns)
    segs = _self_segments(spans)
    starts = [s[0] for s in segs]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segs) and segs[i][0] < g1:
            a, b = max(g0, segs[i][0]), min(g1, segs[i][1])
            if b > a:
                idle[segs[i][2]] += (b - a) / 1e6
            i += 1
    count: Dict[str, int] = defaultdict(int)
    for s in spans:
        count[s["name"]] += 1
    return dict(idle_ms=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
                gap_ms=sum(b - a for a, b in gaps) / 1e6, count=dict(count))


def _launch_ns(events: Sequence[dict], base_ns: int) -> Dict[int, int]:
    """Each launch's host time (ns) by its correlation id."""
    return {e["args"]["correlation"]: base_ns + round(e["ts"] * 1e3) for e in events
            if e.get("cat") in trace_reader._LAUNCH_CATS
            and "correlation" in e.get("args", {})}


def busy_by_span(spans: Sequence[dict], events: Sequence[dict], base_ns: int) -> dict:
    """The device's busy ms (the union of kernel intervals) of the kernels
    launched while each span name was the innermost open on the host
    (OUTSIDE for none), by the launch's correlation; {} where the trace
    holds no launches."""
    launches = _launch_ns(events, base_ns)
    segs = _self_segments(spans)
    starts = [s[0] for s in segs]
    kernels: Dict[str, list] = defaultdict(list)
    for k in trace_reader._kernels(events):
        t = launches.get(k.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        name = segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE
        kernels[name].append((k["ts"], k["ts"] + k["dur"]))
    return {n: trace_reader.union_seconds(iv) * 1e3 for n, iv in kernels.items()}


def upcast_kernels(events: Sequence[dict], leaf: str = "fp8_upcast") -> dict:
    """The kernels launched inside `leaf` ranges of a host and device
    trace: their number and their device ms."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == leaf
                    and "dur" in e)
    starts = [r[0] for r in ranges]
    inside = set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in trace_reader._LAUNCH_CATS and corr is not None:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and ranges[i][1] >= e["ts"]:
                inside.add(corr)
    ks = [e for e in trace_reader._kernels(events)
          if e.get("args", {}).get("correlation") in inside]
    return dict(ranges=len(ranges), kernels=len(ks),
                kernel_ms=sum(e["dur"] for e in ks) / 1e3)


# ------------------------------------------------------------- the requests
def _profiling():
    """The program's `utils.profiling`, or None where it has no recorder."""
    from faithdiff_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def load_trace(path: str) -> Tuple[List[dict], int]:
    """(events, baseTimeNanoseconds) of a Chrome trace of `torch.profiler`:
    `trace_reader.load` drops the base, which lays the spans on the trace."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


def recorded(serve: Callable[[int], object], i: int, activities=None):
    """Request `i` with the recorder on, inside the span `request`, under
    `torch.profiler` with `activities` where given. Returns (spans, host
    wall s, trace events or None, the trace's base ns)."""
    import torch

    profiling = _profiling()
    cuda = torch.cuda.is_available()
    prof, tmp = None, tempfile.mkdtemp(prefix="bench_program_")
    try:
        with profiling.recording() as rec:
            if activities:
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
            t0 = time.perf_counter()
            try:
                with profiling.span("request", index=i):
                    serve(i)
                if cuda:
                    torch.cuda.synchronize()
            finally:
                if prof is not None:
                    prof.__exit__(None, None, None)
            wall = time.perf_counter() - t0
        events, base = None, 0
        if prof is not None:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events, base = load_trace(path)
        return rec.take(), wall, events, base
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _ready() -> bool:
    import torch

    return _profiling() is not None and torch.cuda.is_available()


def unprofiled_request(serve: Callable[[int], object], i: int) -> dict:
    """Request (A) at index `i`: its `spans` and host `wall_s`; {} where the
    program has no recorder or no card. Serve it before any profiler has
    run in the process: after one, the same requests take the host longer
    (PERF.md)."""
    if not _ready():
        return {}
    spans, wall, _, _ = recorded(serve, i)
    return dict(spans=spans, wall_s=wall)


def profiled_requests(serve: Callable[[int], object], i: int, fp8: bool) -> dict:
    """Requests (B) and, with `fp8`, (C) from index `i`: `idle`
    (`idle_by_span`, `busy_ms` from `busy_by_span` and B's `wall_s`) and
    `upcast` (`upcast_kernels`, the UNet calls and upcasts counted); {}
    where the program has no recorder or no card."""
    if not _ready():
        return {}
    import torch

    act = torch.profiler.ProfilerActivity
    spans, wall, events, base = recorded(serve, i, [act.CUDA])
    out = dict(idle=dict(idle_by_span(spans, events, base),
                         busy_ms=busy_by_span(spans, events, base), wall_s=wall))
    del events
    if fp8:
        spans, _, events, _ = recorded(serve, i + 1, [act.CPU, act.CUDA])
        out["upcast"] = dict(upcast_kernels(events), unet_calls=len(named(spans, "unet")),
                             upcasts=sum(s["counters"].get("fp8.upcasts", 0) for s in spans))
    return out


# -------------------------------------------------------------- the readers
def read_program(run) -> dict:
    """The run's `program` ({} where the run has none)."""
    return getattr(run, "program", None) or {}


def span_mean(run, name: str, key: str = "device_ms") -> Optional[float]:
    """The mean `key` of request (A)'s spans named `name`."""
    return mean([s[key] for s in named(read_program(run).get("spans", ()), name)])


def idle_per(run, name: str) -> Optional[float]:
    """The card's idle ms a span named `name` in the run (`span_idle`)."""
    return span_idle(read_program(run), name)


def span_idle(program: dict, name: str) -> Optional[float]:
    """The card's idle ms a span named `name`, untraced: request (A)'s mean
    device time of those spans less their children's, less the busy time of
    request (B)'s kernels launched while such a span was the innermost, over
    B's spans of the name."""
    spans, idle = program.get("spans"), program.get("idle")
    if not spans or not idle or name not in idle.get("busy_ms", {}):
        return None
    own = self_ms(spans)
    device = mean([own[s["id"]] for s in named(spans, name)])
    if device is None:
        return None
    return device - idle["busy_ms"][name] / idle["count"][name]


def setup_span(run, name: str) -> List[dict]:
    return named(read_program(run).get("setup", ()), name)
