"""The MoE layers against their roofline: the least time of the MoE work
that ran inside the program's `moe` ranges of the traced run's eager
caption (`caption_roofline.moe_least_seconds`, from the configuration's
shapes: the prefill's bytes or FLOPs, whichever bound, and for each decode
step the weights of the experts it hits; the ranges count the calls, one a
MoE layer for the prefill and for each decode step) over the device time
of the kernels launched inside those ranges, %."""
import caption_roofline
import program_trace


def read(run):
    c, g = program_trace.read_program(run).get("caption"), run.geometry
    if not c or not c["moe"]["kernel_ms"] or "caption_prompt" not in g:
        return None
    cfg = run.config
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    calls = c["moe"]["ranges"] // layers
    least = caption_roofline.moe_least_seconds(cfg, g["caption_prompt"], calls)
    return 100.0 * least / (c["moe"]["kernel_ms"] / 1e3)
