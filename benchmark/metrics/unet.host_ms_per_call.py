"""The host's time inside each UNet call (the program's `unet` spans of
request (A): `time.time_ns()` around `self.unet(...)`), over the calls:
the enqueue, which the card waits on where it is longer than the call's
device time."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "unet", "host_ms")
