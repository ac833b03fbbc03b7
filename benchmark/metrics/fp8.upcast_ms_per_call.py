"""The card's time of the fp8 weight upcasts a UNet call: request (C)'s
kernels launched inside the program's `fp8_upcast` ranges (by the launch's
correlation in the host and device trace), their device time over the
request's UNet calls."""
import program_trace


def read(run):
    up = program_trace.read_program(run).get("upcast")
    if not up or not up["unet_calls"] or not up["kernels"]:
        return None
    return up["kernel_ms"] / up["unet_calls"]
