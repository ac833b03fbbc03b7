"""The card's time of `FaithDiffPipeline.decode` (VAE decode, colour fix,
the copy to the host), from the CUDA events of the program's `decode`
span of request (A)."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "decode")
