"""BSRNet / RRDBNet degradation remover (counterpart of
`faithdiff_tpu/models/bsrnet.py`), NCHW.

RRDBNet: 23 RRDB blocks of three 5-conv residual dense blocks (nf 64,
gc 32), a trunk conv, and a nearest x2 (x4: twice) upsampling head, under
the reference BSRNet's key names (`conv_first`,
`RRDB_trunk.{i}.RDB{1,2,3}.conv{1..5}`, `trunk_conv`, `upconv1/2`,
`HRconv`, `conv_last`). `deg_remove` runs it tile by tile: 512 px tiles,
each computed from a crop with a 16 px halo, written as non-overlapping
output tiles. Convolutions only, so plain torch (the JAX module has no
Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv(cin: int, cout: int, dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, dtype=dtype)


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(nf, gc, dtype)
        self.conv2 = _conv(nf + gc, gc, dtype)
        self.conv3 = _conv(nf + 2 * gc, gc, dtype)
        self.conv4 = _conv(nf + 3 * gc, gc, dtype)
        self.conv5 = _conv(nf + 4 * gc, nf, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = _lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype=torch.float32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc, dtype)
        self.RDB2 = ResidualDenseBlock5C(nf, gc, dtype)
        self.RDB3 = ResidualDenseBlock5C(nf, gc, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, sf: int = 4, dtype=torch.float32):
        super().__init__()
        if sf not in (2, 4):
            raise ValueError(f"RRDBNet: scale {sf} (2 or 4)")
        self.sf = sf
        self.conv_first = _conv(in_nc, nf, dtype)
        self.RRDB_trunk = nn.Sequential(*(RRDB(nf, gc, dtype) for _ in range(nb)))
        self.trunk_conv = _conv(nf, nf, dtype)
        self.upconv1 = _conv(nf, nf, dtype)
        if sf == 4:
            self.upconv2 = _conv(nf, nf, dtype)
        self.HRconv = _conv(nf, nf, dtype)
        self.conv_last = _conv(nf, out_nc, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        fea = _lrelu(self.upconv1(F.interpolate(fea, scale_factor=2, mode="nearest")))
        if self.sf == 4:
            fea = _lrelu(self.upconv2(F.interpolate(fea, scale_factor=2, mode="nearest")))
        return self.conv_last(_lrelu(self.HRconv(fea)))


@torch.no_grad()
def deg_remove(model: RRDBNet, image: torch.Tensor, tile_size: int = 512,
               tile_pad: int = 16) -> torch.Tensor:
    """Tile-wise restoration of `image` [B, C, H, W] in [0, 1]: each output
    tile of `tile_size * model.sf` px comes from its input tile with a
    `tile_pad` halo (cut at the image's edge), run on the model's device in
    its dtype; the output [B, C, H * sf, W * sf] has the image's device and
    dtype."""
    param = next(model.parameters())
    scale = model.sf
    b, c, h, w = image.shape
    out = torch.zeros((b, c, h * scale, w * scale), dtype=image.dtype,
                      device=image.device)
    for y in range(math.ceil(h / tile_size)):
        for x in range(math.ceil(w / tile_size)):
            ys, xs = y * tile_size, x * tile_size
            ye, xe = min(ys + tile_size, h), min(xs + tile_size, w)
            ysp, xsp = max(ys - tile_pad, 0), max(xs - tile_pad, 0)
            yep, xep = min(ye + tile_pad, h), min(xe + tile_pad, w)
            tile = image[:, :, ysp:yep, xsp:xep].to(param.device, param.dtype)
            out_tile = model(tile)
            oy, ox = (ys - ysp) * scale, (xs - xsp) * scale
            out[:, :, ys * scale:ye * scale, xs * scale:xe * scale] = out_tile[
                :, :, oy:oy + (ye - ys) * scale, ox:ox + (xe - xs) * scale].to(out)
    return out
