"""Every GroupNorm of the traced request (with its SiLU and add) against
its roofline: the least time (x read and y written once in the served
dtype at 3.35 TB/s; the arithmetic at 67 TFLOP/s fp32, the larger),
counted on the reference's GroupNorms at the request's shapes, over the
device time of the trace's GroupNorm kernels."""
import roofline


def read(run):
    t, g = run.trace_summary, run.geometry
    if not t or not t.get("group_norm_s"):
        return None
    least = roofline.group_norm_least_seconds(
        run.config, g["height"], g["width"], g["tiles"], g["tile_chunk"],
        esize=2 if run.config["dtype"] in ("bfloat16", "float16") else 4)
    return 100.0 * least / t["group_norm_s"]
