"""The card's time a UNet call, from the CUDA events of the program's
`unet` spans of request (A), over the calls."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "unet")
