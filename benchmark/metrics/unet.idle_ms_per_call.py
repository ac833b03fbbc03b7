"""The card's idle time while the host was inside a UNet call, untraced:
request (A)'s `unet` spans' device time less the busy time of request
(B)'s kernels launched inside its `unet` spans, over the calls. B's own
gaps carry the profiler's cost a launch; its kernels do not."""
import program_trace


def read(run):
    return program_trace.idle_per(run, "unet")
