"""fp8 weight upcasts a UNet call: the program's counter `fp8.upcasts` of
request (A)'s `unet` spans, over the spans (one a stored tensor where each
is read once a call)."""
import program_trace


def read(run):
    calls = program_trace.named(program_trace.read_program(run).get("spans", ()), "unet")
    if not calls or not any("fp8.upcasts" in s["counters"] for s in calls):
        return None
    return sum(s["counters"].get("fp8.upcasts", 0) for s in calls) / len(calls)
