"""Kernels a decode step: those launched inside the program's
`caption.decode` range (a captured step's replays and its one eager
warm-up step included, by launch correlation) over the caption's decode
steps, in the host and device trace of request (B) (a caption of the
traffic's `trace_new_tokens`)."""
import program_trace


def read(run):
    c = program_trace.read_program(run).get("caption")
    if not c or c["tokens"] < 2 or not c["decode"]["ranges"]:
        return None
    return c["decode"]["kernels"] / (c["tokens"] - c["decode"]["ranges"])
