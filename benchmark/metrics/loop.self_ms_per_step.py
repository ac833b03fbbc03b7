"""An Euler step's card time outside its UNet calls (split, CFG, the
scheduler's step, the merge): each `step` span of request (A) less its
`unet` children, by their CUDA events, over the steps."""
import program_trace


def read(run):
    spans = program_trace.read_program(run).get("spans", ())
    own = program_trace.self_ms(spans)
    return program_trace.mean([own[s["id"]] for s in program_trace.named(spans, "step")])
