"""The UNet's time a call: CUDA events in its forward pre- and post-hooks,
summed over every call of the window, over the calls."""


def read(run):
    ms = run.spans.get("unet_ms")
    return sum(ms) / len(ms) if ms else None
