"""One traced run of a cell that reads the program's own spans too.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds 10

from the root of a checkout, on a card. The run is a `run.py --trace 1`
run without its check (the set-up, here under the program's recorder;
the window with the benchmark's hooks; the two profiled requests), with
requests (A), (B) and (C) of `program_trace.py` added: A after the
window, B and C after the profiled requests. It reads
the cell's per-layer metrics of `BENCHMARK.json` and the metrics over the
program's spans (`PROGRAM_METRICS`, readers in `metrics/`), and prints a
table of the spans to standard error and one JSON line to standard
output: the metrics, request (A)'s time against the window's mean image
time (the recorder's cost when on), and request (B)'s charged idle
against the trace's gap time. It makes no check against the reference
(`run.py` does).

It stands in for the driver until a `benchmark` PR records the program's
spans in `drivers/restore_stream.py` and declares these metrics in
`BENCHMARK.json`; that PR deletes this file.
"""
import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
# (metric, unit): the readers over the program's spans; the fp8 ones are
# read in cells with fp8-stored weights only
PROGRAM_METRICS = (("unet.host_ms_per_call", "ms"), ("unet.span_ms_per_call", "ms"),
                   ("unet.idle_ms_per_call", "ms"), ("loop.span_ms_per_step", "ms"),
                   ("loop.self_ms_per_step", "ms"), ("loop.idle_ms_per_step", "ms"),
                   ("encode.span_ms_per_image", "ms"), ("decode.span_ms_per_image", "ms"),
                   ("setup.pipeline_s", "s"), ("setup.warm_restore_s", "s"))
FP8_METRICS = (("fp8.upcasts_per_call", "upcasts"), ("fp8.upcast_ms_per_call", "ms"))


def span_table(program: dict) -> list:
    """Rows (name, count, host ms, device ms, self ms, idle ms): request
    (A)'s spans summed by name, their self time on the card, and the card's
    untraced idle in them (`program_trace.span_idle`, 0 where unread)."""
    import program_trace

    spans = program.get("spans", [])
    own = program_trace.self_ms(spans)
    rows = {}
    for s in spans:
        r = rows.setdefault(s["name"], [s["name"], 0, 0.0, 0.0, 0.0, 0.0])
        r[1] += 1
        r[2] += s["host_ms"]
        r[3] += s["device_ms"]
        r[4] += own[s["id"]]
    for r in rows.values():
        r[5] = r[1] * (program_trace.span_idle(program, r[0]) or 0.0)
    return list(rows.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    cache = os.path.join(BENCH, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    sys.path.insert(0, BENCH)
    sys.path.insert(1, os.path.dirname(BENCH))
    import torch

    import harness
    import program_trace

    if not torch.cuda.is_available():
        print("needs a CUDA device: no result", file=sys.stderr)
        return 3
    profiling = program_trace._profiling()
    if profiling is None:
        print("the program has no span recorder: no result", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    w, config, traffic, _ = harness.cell_inputs(spec, args.workload)
    run = harness.Run(config, traffic, args.seed, "cuda", {})
    drv = harness.driver(traffic["driver"]).Driver(run)
    with profiling.recording() as rec:
        drv.setup()
        torch.cuda.synchronize()
    setup_spans = rec.take()
    drv.spans_on()
    deadline = time.perf_counter() + args.seconds
    while time.perf_counter() < deadline or not run.records:
        run.records.append(drv.request(len(run.records)))
    drv.spans_off()
    i = len(run.records)
    run.program = dict(program_trace.unprofiled_request(drv.request, i), setup=setup_spans)
    run.trace_summary = drv.traced_request(i + 1)
    run.program.update(program_trace.profiled_requests(drv.request, i + 3, config["use_fp8"]))

    names = [m["name"] for m in harness.cell_metrics(spec, args.workload, True)]
    names += [n for n, _ in PROGRAM_METRICS + (FP8_METRICS if config["use_fp8"] else ())]
    metrics = {n: harness.reader(n)(run) for n in names}
    done = run.done()
    image_s = sum(r["end"] - r["start"] for r in done) / len(done)
    idle = run.program["idle"]
    print(f"{'span':<16}{'count':>6}{'host ms':>12}{'device ms':>12}{'self ms':>12}"
          f"{'idle ms':>10}", file=sys.stderr)
    for r in span_table(run.program):
        print(f"{r[0]:<16}{r[1]:>6}{r[2]:>12.3f}{r[3]:>12.3f}{r[4]:>12.3f}{r[5]:>10.3f}",
              file=sys.stderr)
    for s in setup_spans:
        if s["parent"] is None:
            print(f"set-up {s['name']}: host {s['host_ms']:.1f} ms, device {s['device_ms']:.1f} ms",
                  file=sys.stderr)
    out = dict(workload=args.workload, seed=args.seed, device=torch.cuda.get_device_name(0),
               metrics=metrics, window_images=len(done), window_image_s=image_s,
               recorded_image_s=run.program["wall_s"],
               recorder_cost_pct=100.0 * (run.program["wall_s"] / image_s - 1.0),
               gap_ms=idle["gap_ms"], charged_ms=sum(idle["idle_ms"].values()),
               trace_busy_s=run.trace_summary.get("busy_s"),
               outside_ms=idle["idle_ms"].get(program_trace.OUTSIDE, 0.0),
               idle_ms=idle["idle_ms"], busy_ms=idle["busy_ms"],
               upcast=run.program.get("upcast"),
               idle_gaps=run.trace_summary.get("idle_gaps"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
