"""The restore's time before the loop, an image: from the call's start
(upload, normalisation, denoise encoder, VAE encode and posterior sample,
DDPM noise) to the first UNet call's start, by CUDA events."""


def read(run):
    ms = run.spans.get("encode_ms")
    return sum(ms) / len(ms) if ms else None
