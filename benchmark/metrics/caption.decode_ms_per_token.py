"""A decode step of the caption: the program's `caption.decode` span over
its steps (the `caption.tokens` counter, less the prefill's token),
request (A), ms. The span holds what a request's decode does: where the
step is replayed, its capture too (one eager step and the capture, once a
caption)."""
import program_trace


def read(run):
    spans = program_trace.read_program(run).get("spans", ())
    decode = program_trace.named(spans, "caption.decode")
    tokens = sum(s["counters"].get("caption.tokens", 0) for s in spans)
    if not decode or tokens < 2:
        return None
    return sum(s["device_ms"] for s in decode) / (tokens - len(decode))
