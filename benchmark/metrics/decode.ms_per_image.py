"""`FaithDiffPipeline.decode` to uint8 (VAE decode, colour fix, the copy
to the host), an image, by CUDA events around the call."""


def read(run):
    ms = run.spans.get("decode_ms")
    return sum(ms) / len(ms) if ms else None
