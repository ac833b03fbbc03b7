"""Tracing and profiling (counterpart of `faithdiff_tpu/utils/profiling.py`).

- `phase(name)`: wall-clock seconds per phase in a process-wide registry,
  read by `phase_report`, `print_phase_report`, `save_phase_report`;
- `trace(log_dir)`: a `torch.profiler` trace of the CPU and the card,
  written as a Chrome trace to `<log_dir>/trace.json`;
- `annotate(name)`: a labelled range on that timeline
  (`torch.profiler.record_function`);
- `device_sync(x)`: wait for the card's work on `x`;
- `time_ms(fn, ...)`: a call's device time from CUDA events;
- `kernel_events(path)` and `device_split(kernels, classes)`: a trace's
  kernels, their device time by class and by name, and the card's busy
  share between the first kernel's start and the last one's end.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch

_PHASES: Dict[str, list] = defaultdict(list)


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def device_sync(x: Any = None) -> None:
    """Wait until the card has finished the work queued on the current
    stream of each CUDA device that holds a tensor of `x` (a tensor, or
    lists, tuples and dicts of them); without one, `torch.cuda.synchronize()`
    where a card exists."""
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    if not devices and x is None and torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, sync: Any = None) -> Iterator[None]:
    """Time a phase (host wall clock; pass `sync=tensors` to include the
    card's completion of their work)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            device_sync(sync)
        _PHASES[name].append(time.perf_counter() - t0)


def phase_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    report = {}
    for name, times in _PHASES.items():
        report[name] = {
            "count": len(times),
            "total_s": sum(times),
            "mean_s": sum(times) / len(times),
            "last_s": times[-1],
        }
    if reset:
        _PHASES.clear()
    return report


def print_phase_report(reset: bool = True) -> None:
    for name, row in sorted(phase_report(reset).items()):
        print(f"[phase] {name}: n={row['count']} "
              f"mean={row['mean_s'] * 1e3:.1f}ms total={row['total_s']:.2f}s")


def save_phase_report(path: str) -> None:
    with open(path, "w") as f:
        json.dump(phase_report(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card exists) and write the
    Chrome trace to `<log_dir>/trace.json`. Yields the profiler (its
    `key_averages()` after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Label a range on the profiler's timeline."""
    return torch.profiler.record_function(name)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call of `fn`, from CUDA events around
    `iters` calls after `warmup` calls."""
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


def kernel_events(path: str) -> Tuple[List[dict], List[dict]]:
    """(kernels, events) of a Chrome trace that `trace` wrote: the device
    kernels (events of category "kernel" with a duration) and every event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e], events


def busy(kernels: Sequence[dict]) -> Tuple[float, float]:
    """(busy ms, span ms): the time at least one kernel ran, and the time
    from the first kernel's start to the last one's end."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total, end = 0.0, spans[0][0]
    for s, t in spans:
        total += max(0.0, t - max(s, end))
        end = max(end, t)
    return total / 1e3, (end - spans[0][0]) / 1e3


def device_split(kernels: Sequence[dict],
                 classes: Sequence[Tuple[str, str]]) -> dict:
    """Device ms of `kernels` by class (the first `(fragment, class)` of
    `classes` whose fragment is in the lower-cased kernel name, else
    "other") and by kernel name, their sum, the span and the busy share."""
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for e in kernels:
        name = e["name"]
        cls = next((c for frag, c in classes if frag in name.lower()), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1e3
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    busy_ms, span_ms = busy(kernels)
    return dict(kernels=len(kernels), kernel_ms=sum(by_class.values()),
                span_ms=span_ms, busy_share=busy_ms / span_ms,
                by_layer={k: v for k, v in sorted(by_class.items(),
                                                  key=lambda kv: -kv[1])},
                by_name=by_name)
