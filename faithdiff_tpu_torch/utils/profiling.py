"""Tracing and profiling (counterpart of `faithdiff_tpu/utils/profiling.py`).

- `phase(name)`: wall-clock seconds per phase in a process-wide registry,
  read by `phase_report`, `print_phase_report`, `save_phase_report`;
- `trace(log_dir)`: a `torch.profiler` trace of the CPU and the card,
  written as a Chrome trace to `<log_dir>/trace.json`;
- `span(name, **attrs)`, `count(name, n)`, `leaf(name)` and `recording()`:
  the program's spans and counters, recorded only inside a `recording()`
  block (host stamps on the clock of the profiler's Chrome trace, CUDA
  events on a card); while a profiler runs a span is also a labelled
  range on its timeline (`torch.profiler.record_function`), and with
  neither it costs two checks;
- `device_sync(x)`: wait for the card's work on `x`;
- `time_ms(fn, ...)`: a call's device time from CUDA events;
- `kernel_events(path)` and `device_split(kernels, classes)`: a trace's
  kernels, their device time by class and by name, and the card's busy
  share between the first kernel's start and the last one's end.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

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


_NULL = contextlib.nullcontext()
RECORD_LIMIT = 100_000           # spans a recording keeps; it counts the rest
_recorder: Optional["Recording"] = None
_local = threading.local()       # `spans`: the thread's open recorded spans


def _open_spans() -> list:
    spans = getattr(_local, "spans", None)
    if spans is None:
        spans = _local.spans = []
    return spans


def _event() -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Recording:
    """The spans and counters recorded in one `recording()` block. `take()`
    resolves them; on a card, call it after a synchronise of the caller's
    own (the recorder itself never waits for the card). At most
    `RECORD_LIMIT` spans are kept; `dropped` counts the rest. `counters`
    holds counts made while no span was open."""

    def __init__(self):
        self.limit, self.cuda, self.dropped = RECORD_LIMIT, torch.cuda.is_available(), 0
        self.counters: Dict[str, int] = defaultdict(int)
        self._done: List["_Span"] = []
        self._ids = itertools.count()
        self._lock = threading.Lock()     # spans end and count in any thread
        self._origin_ns = time.time_ns()
        self._origin = _event() if self.cuda else None

    def _finish(self, span: "_Span") -> None:
        with self._lock:
            if len(self._done) < self.limit:
                self._done.append(span)
            else:
                self.dropped += 1

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] += n

    def _device_ms(self, span: "_Span") -> Tuple[float, float]:
        if self._origin is None:
            return ((span.start_ns - self._origin_ns) / 1e6,
                    (span.end_ns - self._origin_ns) / 1e6)
        return (self._origin.elapsed_time(span.events[0]),
                self._origin.elapsed_time(span.events[1]))

    def take(self) -> List[dict]:
        """The finished spans in the order they opened: `name`, `id`,
        `parent` (the id of the span open around it in its thread, or None),
        `attrs`, `start_ns` / `end_ns` (`time.time_ns()`, the clock of
        `torch.profiler`'s Chrome trace: `baseTimeNanoseconds` + 1000 ts),
        `host_ms`, `device_start_ms` / `device_end_ms` (from the block's
        start: CUDA events on the stream that was current, or the host
        clock without a card), `device_ms` and `counters`."""
        out = []
        for s in sorted(self._done, key=lambda s: s.id):
            d0, d1 = self._device_ms(s)
            out.append(dict(name=s.name, id=s.id, parent=s.parent, attrs=s.attrs,
                            start_ns=s.start_ns, end_ns=s.end_ns,
                            host_ms=(s.end_ns - s.start_ns) / 1e6,
                            device_start_ms=d0, device_end_ms=d1,
                            device_ms=d1 - d0, counters=dict(s.counters)))
        return out


class _Span:
    """One recorded span (`span` while the recorder is on)."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "counters", "start_ns",
                 "end_ns", "events", "range")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.counters: Dict[str, int] = defaultdict(int)
        self.range = self.events = None

    def __enter__(self) -> "_Span":
        # stamped before the range: a profiler's first range takes ms to open
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        spans = _open_spans()
        self.parent = spans[-1].id if spans else None
        self.id = next(self.rec._ids)
        spans.append(self)
        if self.rec.cuda:
            self.events = (_event(), None)
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events = (self.events[0], _event())
        _open_spans().pop()
        self.rec._finish(self)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A span of the program named `name` with its `attrs`: recorded while a
    `recording()` block is on (its host stamps, its CUDA events, its parent
    and its counters); a `torch.profiler.record_function` range of the same
    name while a profiler runs; with neither, a shared null context."""
    rec = _recorder
    if rec is None:
        if not torch.autograd._profiler_enabled():
            return _NULL
        return torch.profiler.record_function(name)
    return _Span(rec, name, attrs)


def recording_on() -> bool:
    """Whether a `recording()` block is on."""
    return _recorder is not None


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the innermost open span of the thread
    (of the recording, outside any span) while the recorder is on."""
    rec = _recorder
    if rec is None:
        return
    spans = _open_spans()
    if spans:
        spans[-1].counters[name] += n      # the thread's own span
    else:
        rec._count(name, n)


def leaf(name: str):
    """A profiler range `name` with no recorded span, only while the
    recorder is on and a profiler runs (a shared null context otherwise):
    for sites too frequent for spans of their own."""
    if _recorder is None or not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the program's spans and counters inside the block (one block
    at a time); where a card is there, each span gets a pair of CUDA
    events."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None


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
