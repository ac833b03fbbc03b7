"""Share of an image's time in which no kernel runs on the card: 100 * (1 -
the device's busy time over a traced request (the union of its kernel
intervals, from the device trace) / the window's mean image time). The
window's untraced time, not the traced request's: the profiler's cost a
launch lengthens the traced request on the host (by a fifth at 1024x1536)
while the kernels' own time stays."""


def read(run):
    t, done = run.trace_summary, run.done()
    if not t or not t.get("busy_s") or not done:
        return None
    per_image = sum(r["end"] - r["start"] for r in done) / len(done)
    return 100.0 * (1.0 - t["busy_s"] / per_image)
