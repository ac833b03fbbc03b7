"""The card's time an Euler step (split, the UNet calls, CFG, the
scheduler's step, the merge), from the CUDA events of the program's `step`
spans of request (A), over the steps."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "step")
