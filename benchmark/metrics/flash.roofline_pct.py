"""The UNet's self-attention against its roofline: the least time of the
traced request's self-attention work (from the configuration's shapes:
4 * B * H * S^2 * d FLOPs at 989 TFLOP/s, q, k, v, o once at 3.35 TB/s,
the larger) over the device time of the trace's attention kernels. The
same work is counted whatever kernel computes it; without such kernels in
the trace it reports nothing."""
import roofline


def read(run):
    t, g = run.trace_summary, run.geometry
    if not t or not t.get("attention_s"):
        return None
    least = roofline.flash_least_restore(run.config["unet"], g["latent_tile"], g["tiles"],
                                         g["tile_chunk"], g["steps"])
    return 100.0 * least / t["attention_s"]
