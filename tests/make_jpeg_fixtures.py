"""Write the JPEG fixtures of `tests/data/jpeg/` and their manifest.

    python tests/make_jpeg_fixtures.py [--out tests/data/jpeg]

Needs Pillow (with libjpeg-turbo), so it runs only where Pillow is: the
fixtures are committed, and the GPU machine, which has no Pillow, checks
the port's decoder against the manifest (`chip_smoke.py`'s `jpeg_decode`
phase). It is not part of the port package, which imports no PIL.

Every image is a seeded synthetic scene (smooth gradients, hard-edged
shapes, fine texture) saved by Pillow at the settings in `FIXTURES`. The
manifest gives each file's shape, its settings and the SHA-256 of
`np.asarray(Image.open(f).convert("RGB"))` (its bytes, C order), with the
Pillow and libjpeg-turbo versions that made them.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "jpeg")
# name -> ((height, width), seed, Pillow save settings); "mode": "L" saves
# a grayscale file. restore_128 is the 128 x 128 photo that `cli.py
# restore` at --upscale 2 pads to 256 x 256 (one 32 x 32 latent tile); the
# 1024 x 1536 pair are the timed baseline and progressive files.
FIXTURES = {
    "restore_128.jpg": ((128, 128), 1, dict(quality=90)),
    "photo_1024x1536.jpg": ((1024, 1536), 2, dict(quality=75)),
    "photo_1024x1536_progressive.jpg": ((1024, 1536), 2,
                                        dict(quality=75, progressive=True)),
    "q50_444.jpg": ((96, 128), 3, dict(quality=50, subsampling=0)),
    "q95_422_optimize.jpg": ((80, 120), 4, dict(quality=95, subsampling=1,
                                                optimize=True)),
    "q75_420_restart_blocks.jpg": ((72, 88), 5, dict(quality=75, subsampling=2,
                                                     restart_marker_blocks=3)),
    "q75_420_restart_rows.jpg": ((72, 88), 6, dict(quality=75, subsampling=2,
                                                   restart_marker_rows=1)),
    "odd_53x37_progressive.jpg": ((53, 37), 7, dict(quality=80, progressive=True)),
    "gray_61x45.jpg": ((61, 45), 8, dict(quality=85, mode="L")),
    "tiny_1x1.jpg": ((1, 1), 9, dict(quality=75)),
}


def scene(hw, seed: int) -> np.ndarray:
    """[H, W, 3] uint8: gradients, shapes with hard edges, fine texture."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64) / max(h, w, 2)
    f = rng.uniform(0.5, 2.0, 3)
    img = np.stack([0.5 + 0.35 * np.sin(2 * np.pi * (f[0] * x + 0.3 * y)),
                    0.5 + 0.35 * np.cos(2 * np.pi * (f[1] * y - 0.2 * x)),
                    0.45 + 0.3 * np.sin(2 * np.pi * f[2] * (x + y))], -1)
    for _ in range(6):
        y0, x0 = rng.uniform(0, 1, 2) * (h, w)
        ry, rx = rng.uniform(0.05, 0.3, 2) * (h, w)
        colour = rng.uniform(0, 1, 3)
        if rng.random() < 0.5:
            inside = (np.abs(y * max(h, w) - y0) < ry) & (np.abs(x * max(h, w) - x0) < rx)
        else:
            inside = ((y * max(h, w) - y0) / ry) ** 2 + ((x * max(h, w) - x0) / rx) ** 2 < 1
        img[inside] = colour
    noise = rng.normal(0, 1, (h + 2, w + 2, 3))
    texture = sum(noise[i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9
    img = img + 0.04 * texture
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def rgb_sha256(path: str) -> tuple:
    from PIL import Image

    rgb = np.ascontiguousarray(np.asarray(Image.open(path).convert("RGB")))
    return list(rgb.shape), hashlib.sha256(rgb.tobytes()).hexdigest()


def versions() -> dict:
    import PIL
    from PIL import features

    return {"pillow": PIL.__version__,
            "libjpeg_turbo": features.version("libjpeg_turbo")}


def main(argv=None) -> int:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    files = {}
    for name, (hw, seed, settings) in FIXTURES.items():
        settings = dict(settings)
        mode = settings.pop("mode", "RGB")
        path = os.path.join(args.out, name)
        Image.fromarray(scene(hw, seed)).convert(mode).save(path, "JPEG", **settings)
        shape, digest = rgb_sha256(path)
        files[name] = dict(shape=shape, rgb_sha256=digest, bytes=os.path.getsize(path),
                           progressive=bool(settings.get("progressive")),
                           settings=dict(settings, mode=mode))
    manifest = dict(versions(), files=files)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(v["bytes"] for v in files.values())
    print(f"{len(files)} files, {total} bytes, in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
