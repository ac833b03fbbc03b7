"""The set-up's warm restore at the cell's shapes: from its program span
`restore`'s start to the end of the `decode` span after it, the larger of
the host's and the card's time."""
import program_trace


def read(run):
    restores = program_trace.setup_span(run, "restore")
    if not restores:
        return None
    r = restores[-1]
    dec = [d for d in program_trace.setup_span(run, "decode") if d["start_ns"] >= r["end_ns"]]
    if not dec:
        return None
    host = dec[0]["end_ns"] - r["start_ns"]
    device = (dec[0]["device_end_ms"] - r["device_start_ms"]) * 1e6
    return max(host, device) / 1e9
