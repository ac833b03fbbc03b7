"""The card's idle time while the host was in an Euler step but outside
its UNet calls, untraced: request (A)'s `step` spans' device time less
their `unet` children's, less the busy time of request (B)'s kernels
launched while `step` was the innermost span, over the steps."""
import program_trace


def read(run):
    return program_trace.idle_per(run, "step")
