"""The traffic generator: one request stream from a traffic file's
parameters and the run's seed.

A traffic file (`traffic/<name>.json`) names its `driver` and gives the
parameters that the generator reads:

- `height`, `width`: the output size in pixels (multiples of 8);
- `photo_scale`: the input is a photo of `height / photo_scale` x
  `width / photo_scale` brought up to the output size, as the restore
  command's `--upscale` does;
- `prompt_tokens`, `prompt_dim`, `pooled_dim`: the prompt embeddings'
  shape (the SDXL text towers' output);
- `pool`: how many distinct requests are made before the window; a window
  that outruns the pool starts over on its first inputs with fresh noise
  seeds.

Every request has its own seeded uint8 image, its own positive and negative
prompt embeddings and its own noise seed. All requests of a stream have the
same sizes, so every seed gives the same work; the seed changes only the
values.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

_SALT = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class Request:
    index: int
    image: np.ndarray           # [H, W, 3] uint8, on the host
    prompt: torch.Tensor        # [1, tokens, dim] fp32, on the device
    pooled: torch.Tensor        # [1, pooled_dim]
    neg_prompt: torch.Tensor
    neg_pooled: torch.Tensor
    noise_seed: int


def noise_seed(seed: int, index: int) -> int:
    """The pipeline's noise seed of request `index` (any whole `seed`)."""
    return (int(seed) * 1_000_003 + index * _SALT + 1) % (1 << 63)


@torch.no_grad()
def make_requests(traffic: dict, seed: int, device) -> List[Request]:
    """The stream's `pool` requests, made on `device` in a few calls."""
    n, h, w = traffic["pool"], traffic["height"], traffic["width"]
    s = traffic["photo_scale"]
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ _SALT) % (1 << 63))
    # a photo: a smooth field plus fine detail at the photo's size, then
    # brought up to the output size
    ph, pw = h // s, w // s
    coarse = torch.rand((n, 3, max(1, ph // 16), max(1, pw // 16)),
                        generator=gen, device=device)
    fine = torch.rand((n, 3, ph, pw), generator=gen, device=device)
    photo = 0.7 * F.interpolate(coarse, size=(ph, pw), mode="bilinear",
                                align_corners=False) + 0.3 * fine
    image = F.interpolate(photo, size=(h, w), mode="bilinear", align_corners=False)
    image = torch.round(image.clamp(0, 1) * 255).to(torch.uint8)
    images = image.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    t, d, pd = traffic["prompt_tokens"], traffic["prompt_dim"], traffic["pooled_dim"]
    emb = torch.randn((n, 2, t, d), generator=gen, device=device)
    pooled = torch.randn((n, 2, pd), generator=gen, device=device)
    return [Request(index=i, image=images[i], prompt=emb[i, :1], pooled=pooled[i, :1],
                    neg_prompt=emb[i, 1:], neg_pooled=pooled[i, 1:],
                    noise_seed=noise_seed(seed, i))
            for i in range(n)]


def request_at(requests: List[Request], seed: int, index: int) -> Request:
    """Request `index` of the stream: the pool's inputs in turn, each with
    the noise seed of its own index."""
    r = requests[index % len(requests)]
    return dataclasses.replace(r, index=index, noise_seed=noise_seed(seed, index))
