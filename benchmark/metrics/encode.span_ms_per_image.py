"""The card's time from the upload through the noise and the conditioning
tensors (denoise encoder, VAE encode, posterior draw, DDPM noise), from
the CUDA events of the program's `encode` span of request (A)."""
import program_trace


def read(run):
    return program_trace.span_mean(run, "encode")
