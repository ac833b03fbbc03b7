"""The caption's share of a request: the `caption` span over the
`request` span around it, on the card, request (A), %."""
import program_trace


def read(run):
    caption = program_trace.span_mean(run, "caption")
    request = program_trace.span_mean(run, "request")
    if caption is None or not request:
        return None
    return 100.0 * caption / request
