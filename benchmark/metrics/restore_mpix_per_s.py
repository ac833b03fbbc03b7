"""Output megapixels of the window's whole images over the time from the
first image's start to the last image's end (each image ends synchronised:
its uint8 output is on the host). A failed or stalled image lowers it."""


def read(run):
    done = run.done()
    if not done:
        return None
    span = max(r["end"] for r in run.records) - min(r["start"] for r in run.records)
    return sum(r["pixels"] for r in done) / span / 1e6
