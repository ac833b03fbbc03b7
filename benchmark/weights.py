"""Seeded weights of a configuration, made on the device in a few large
calls, in the dtype they are served in.

The names and shapes come from the plain reference's modules on the meta
device (diffusers' / FaithDiff.bin's names, which the program loads
strictly). Each network's tensors are views into one N(0, 1) draw of a
`torch.Generator` on the device, scaled in place: weight matrices and
convolution kernels by 1 / sqrt(fan_in), biases by 0.05, norm scales to
1 + 0.1 N(0, 1). The fusion's output projections are drawn like every
other weight (a released checkpoint's are not zero), so the fusion path
changes the result. The same seed gives the same bits on the same device.
"""
from __future__ import annotations

from typing import Dict

import torch

from reference.models import build_models

NETWORKS = ("unet", "vae", "denoise_encoder")


def _is_norm_scale(name: str, t: torch.Tensor) -> bool:
    return t.ndim == 1 and name.endswith("weight")


@torch.no_grad()
def make_state_dicts(config: dict, seed: int, device, dtype=torch.bfloat16
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{network: state dict} of `dtype` tensors on `device` from `seed`."""
    shapes = {net: [(k, v.shape, v.ndim) for k, v in m.state_dict().items()]
              for net, m in build_models(config, "meta").items()}
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = {}
    for net in NETWORKS:
        total = sum(s.numel() for _, s, _ in shapes[net])
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        sd, off = {}, 0
        for name, shape, ndim in shapes[net]:
            t = flat[off:off + shape.numel()].view(shape)
            off += shape.numel()
            if ndim >= 2:
                t.mul_(shape[1:].numel() ** -0.5)
            elif _is_norm_scale(name, t):
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.05)
            sd[name] = t
        out[net] = sd
    return out
