"""The LM's prefill over the prompt (the program's `caption.prefill` span:
the forward over ~620 tokens and the first token's sampling), request (A),
ms."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "caption.prefill")
