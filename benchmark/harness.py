"""The benchmark harness: one run of one cell of `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name in `BENCHMARK.json`:

- `configs/<config>.json` (the entry's `file`): the sizes as run;
- `traffic/<traffic>.json`: the mix's parameters, and the `driver` that
  serves it (`drivers/<driver>.py`, which builds the system under test
  from the configuration, makes the requests with `generator.py`, serves
  them and checks them against the plain reference);
- `metrics/<metric>.py`: a reader, `read(run) -> float | None`, over the
  run's records, spans and trace;
- `limits/<cell>.json`: the limit of each number that decides `correct`.

A run: set-up (the program, weights from the seed, the cell's requests, a
warm restore at the cell's shapes), then a closed loop of requests for
`--seconds` that finishes the request in flight, then (with `--trace 1`)
one more request under the profiler, then the check against the reference
once the program is freed. The last line of standard output is the result.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "faithdiff_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `faithdiff_tpu_torch` is not
    `faithdiff_tpu`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    return _module(os.path.join(BENCH, "metrics", metric + ".py"),
                   "bench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def driver(name: str):
    """The module `drivers/<name>.py`."""
    return _module(os.path.join(BENCH, "drivers", name + ".py"),
                   "bench_driver_" + name.replace("-", "_"))


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_inputs(spec: dict, name: str, root: str = ROOT):
    """(cell, configuration, traffic, limits) of a cell, each read from
    its own file."""
    w = cell(spec, name)
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH, "limits", name + ".json"))
    return w, config, traffic, limits


def cell_metrics(spec: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell `name` reports: its end-to-end ones, or
    with `trace` its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


class Run:
    """What a run hands its driver and its metric readers."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 overrides: dict):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device, self.overrides = device, overrides
        self.records: List[dict] = []     # one a request: start, end, pixels, ...
        self.setup_s: Optional[float] = None
        self.peak_bytes = 0
        self.spans: Dict[str, list] = {}  # the driver's span lists (trace runs)
        self.trace_summary: dict = {}     # `trace.analyse` of the traced request
        self.geometry: dict = {}          # the driver's shapes, for work counts

    def done(self) -> List[dict]:
        return [r for r in self.records if not r.get("error")]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[dict] = None,
             overrides: Optional[dict] = None,
             t_start: Optional[float] = None, inputs=None):
    """One run of cell `name`. Returns (result, checks, error): the result
    dict of the last line, the compared numbers [(name, value, limit)], and
    an error text where no result may be printed."""
    import torch

    t_start = time.time() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    w, config, traffic, limits = inputs or cell_inputs(spec, name)
    run = Run(config, traffic, seed, device, overrides or {})
    drv = driver(traffic["driver"]).Driver(run)
    drv.setup()
    if trace:
        drv.spans_on()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.time() - t_start

    deadline = time.perf_counter() + seconds
    failures_in_row = 0
    while time.perf_counter() < deadline or not run.records:
        i = len(run.records)
        try:
            run.records.append(drv.request(i))
            failures_in_row = 0
        except Exception as e:          # a request that fails counts, and the loop goes on
            now = time.perf_counter()
            run.records.append(dict(index=i, start=now, end=now, pixels=0,
                                    error=f"{type(e).__name__}: {e}"))
            print(f"request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
            failures_in_row += 1
            if failures_in_row >= 3:
                break
    if cuda:
        torch.cuda.synchronize()
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    print("request seconds: " + " ".join(f"{r['end'] - r['start']:.4f}" for r in run.records),
          file=sys.stderr)
    if trace:
        drv.spans_off()
        run.trace_summary = drv.traced_request(len(run.records))

    numbers = drv.check() if run.done() else {}
    checks = [(k, numbers.get(k, float("nan")), float(v)) for k, v in limits.items()]
    failed = sum(1 for r in run.records if r.get("error"))
    correct = (failed == 0 and bool(checks)
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))

    metrics = {}
    for m in cell_metrics(spec, name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": run.peak_bytes}
    if trace and run.trace_summary:
        dev["busy_s"] = run.trace_summary["busy_s"]
        dev["window_s"] = run.trace_summary["window_s"]
    result = {"correct": correct, "attempted": len(run.records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace_summary:
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in list(run.trace_summary["by_class"].items())[:10]],
            "idle_gaps": [[k, v] for k, v in list(run.trace_summary["idle_gaps"].items())[:10]]}
    # after the window, in the process that prints the result
    found = forbidden_modules()
    if found:
        return None, [], "modules of the JAX package or JAX loaded: " + ", ".join(found)
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks, None


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec()
    w = cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {w['chips']} CUDA device(s), found {have}: no result",
              file=sys.stderr)
        return 3
    result, checks, error = run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", spec, t_start=t_start)
    if error:
        print(error, file=sys.stderr)
        return 4
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
