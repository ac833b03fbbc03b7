"""The caption of an image (the program's `caption` span: vision tower,
prefill and decode) on the card, request (A), ms."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "caption")
