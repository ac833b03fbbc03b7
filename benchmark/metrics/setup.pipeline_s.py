"""`build_pipeline` in the set-up (the networks built, the seeded weights
loaded, the cast, the fp8 storage): the larger of its program span's host
and device durations."""
import program_trace


def read(run):
    spans = program_trace.setup_span(run, "build_pipeline")
    return max(spans[-1]["host_ms"], spans[-1]["device_ms"]) / 1e3 if spans else None
