"""The wide flash kernel (d = 192, the MLA prefill) against its roofline:
the least time of one caption's prefill attention in every layer
(`caption_roofline.flash_wide_least_seconds`, v and o at their true width
of 128, so the kernel's padding to 192 shows as lost roofline) over the
device time of the `flash_wide` kernels of request (B), %."""
import caption_roofline
import program_trace


def read(run):
    c, g = program_trace.read_program(run).get("caption"), run.geometry
    if not c or not c["wide_ms"] or "caption_prompt" not in g:
        return None
    least = caption_roofline.flash_wide_least_seconds(run.config, g["caption_prompt"])
    return 100.0 * least / (c["wide_ms"] / 1e3)
