"""Kernels launched from inside the UNet's forward, a call: the traced
request's kernels whose launch lies in a `bench.unet` range, over the
ranges."""


def read(run):
    t = run.trace_summary
    if not t or not t.get("unet_calls"):
        return None
    return t["unet_launches"] / t["unet_calls"]
