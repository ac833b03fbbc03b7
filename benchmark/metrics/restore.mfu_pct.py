"""The whole path's share of the card's bf16 peak: the model FLOPs of the
window's whole images (counted once a shape by `FlopCounterMode` over the
plain reference on the meta device: denoise encoder, VAE encode, every
UNet call, VAE decode) over the window's time (first start to last end)
times 989 TFLOP/s."""
import roofline


def read(run):
    done, g = run.done(), run.geometry
    if not done or not g:
        return None
    span = max(r["end"] for r in run.records) - min(r["start"] for r in run.records)
    flops = roofline.restore_flops(run.config, g["height"], g["width"], g["tiles"],
                                   g["tile_chunk"], g["prompt_tokens"])
    return 100.0 * flops * len(done) / span / roofline.PEAK_BF16_FLOPS
