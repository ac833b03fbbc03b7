"""The Euler loop's time a step: from each image's first UNet call's start
to its last UNet call's end (CUDA events in the UNet's forward hooks),
summed over the window's images, over their steps."""


def read(run):
    s = run.spans
    if not s.get("loop_ms"):
        return None
    return sum(s["loop_ms"]) / sum(s["steps"])
