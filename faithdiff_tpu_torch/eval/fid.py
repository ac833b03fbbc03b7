"""FID: InceptionV3 pool3 features + Frechet distance (counterpart of
`faithdiff_tpu/eval/fid.py`).

- the full InceptionV3 graph (FID variant: BasicConv2d = conv + BN eps
  1e-3 + ReLU, average pools with count_include_pad=False as in
  pytorch-fid), NCHW;
- a converter from the torchvision / pytorch-fid state-dict naming;
- weight-free FID math: activation statistics + Frechet distance (scipy
  `sqrtm`, float64, on the host).

`make_fid_features` is weights-gated. Its file is the JAX harness's:
`inception_v3_fid.npz`, which despite its name holds flax's msgpack
serialisation of the param tree (`read_flax_msgpack` / `write_flax_msgpack`
are the port's own reader and writer of that format: msgpack maps, arrays
as ext type 1 of `(shape, dtype name, bytes)`), or beside it a torch `.pth`
in torchvision / pytorch-fid names. Images go to 299x299 as
`jax.image.resize(..., "bilinear")` takes them there: a triangle kernel
widened by the scale when shrinking (`data.degradation.resize`, "area").
"""
from __future__ import annotations

import os
import struct
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.degradation import resize
from ..utils.convert import _flatten
from .lpips import _to_numpy, fp32_exact, load_tree_, network, resolve_device


# ---------------------------------------------------------------------------
# Frechet distance (weight-free)
# ---------------------------------------------------------------------------

def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] features -> (mu [D], cov [D, D])."""
    mu = np.mean(feats, axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrtm_quiet(m: np.ndarray) -> np.ndarray:
    """scipy's `sqrtm(m, disp=False)[0]`: SciPy 1.18 dropped `disp` (and
    returns the root alone), as the card's machine's SciPy has."""
    import inspect

    from scipy import linalg

    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(m, disp=False)[0]
    return linalg.sqrtm(m)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(c1 + c2 - 2 (c1 c2)^(1/2))."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2
    try:
        from scipy import linalg

        covmean = _sqrtm_quiet(cov1 @ cov2)
        if not np.isfinite(covmean).all():
            offset = np.eye(cov1.shape[0]) * eps
            covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
    except ImportError:  # pragma: no cover - scipy is on both machines
        # eigen fallback: tr sqrtm(c1 c2) = sum sqrt(eig(c1 c2))
        w = np.linalg.eigvals(cov1 @ cov2)
        tr_covmean = np.sum(np.sqrt(np.maximum(w.real, 0.0)))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * tr_covmean)


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    m1, c1 = activation_statistics(feats1)
    m2, c2 = activation_statistics(feats2)
    return frechet_distance(m1, c1, m2, c2)


# ---------------------------------------------------------------------------
# InceptionV3 (FID variant), NCHW
# ---------------------------------------------------------------------------

def _avg_pool_nocount(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool with count_include_pad=False (the
    pytorch-fid quirk in InceptionA/C/E)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class BasicConv2d(nn.Module):
    """conv (no bias) + eval-mode BatchNorm eps 1e-3 + ReLU; `padding` an
    int or ((top, bottom), (left, right)) with equal sides, as in flax."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 padding: Any = 0):
        super().__init__()
        if not isinstance(padding, int):
            padding = (padding[0][0], padding[1][0])
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))
        self.bn_mean = nn.Parameter(torch.zeros(cout))
        self.bn_var = nn.Parameter(torch.ones(cout))

    def forward(self, x):
        x = self.conv(x)
        v = lambda p: p[None, :, None, None]  # noqa: E731
        x = (x - v(self.bn_mean)) * torch.rsqrt(v(self.bn_var) + 1e-3) \
            * v(self.bn_scale) + v(self.bn_bias)
        return F.relu(x)


_W7 = ((0, 0), (3, 3))   # 1x7
_H7 = ((3, 3), (0, 0))   # 7x1


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=_W7)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=_H7)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=_H7)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=_W7)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=_H7)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=_W7)
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=_W7)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=_H7)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=((0, 0), (1, 1)))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=((1, 1), (0, 0)))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=((0, 0), (1, 1)))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=((1, 1), (0, 0)))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """InceptionV3 up to the 2048-d pool3 features (the FID extractor).

    Input: [B, 299, 299, 3] in [0, 1]; internally mapped to [-1, 1]
    (pytorch-fid's normalize_input)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))   # global average pool -> [B, 2048]


# ---------------------------------------------------------------------------
# torchvision / pytorch-fid state-dict converter
# ---------------------------------------------------------------------------

_BN_LEAVES = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
              "bn_var": "running_var"}


def convert_inception(state_dict) -> dict:
    """torchvision InceptionV3 (or pytorch-fid FIDInceptionV3) state dict ->
    the flax tree of `InceptionV3Features`. Drops the classifier head and
    aux logits."""
    tree: dict = {}
    for key, value in state_dict.items():
        if key.startswith(("fc.", "AuxLogits.")):
            continue
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        # <block>.conv.weight / <block>.bn.{weight,bias,running_mean,var}
        *prefix, mod, leaf = parts
        arr = _to_numpy(value)
        node = tree
        for p in prefix:
            node = node.setdefault(p, {})
        if mod == "conv" and leaf == "weight":
            node.setdefault("conv", {})["kernel"] = arr.transpose(2, 3, 1, 0)
        elif mod == "bn":
            node[{v: k for k, v in _BN_LEAVES.items()}[leaf]] = arr
        else:
            raise KeyError(f"unhandled inception key {key}")
    return tree


def torchvision_state_dict(tree) -> dict:
    """The inverse of `convert_inception`: the flax tree as torchvision /
    pytorch-fid names (`<block>.conv.weight`, `<block>.bn.*`)."""
    sd = {}
    for path, arr in _flatten(tree):
        block, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            key, arr = block + ".weight", np.asarray(arr).transpose(3, 2, 0, 1)
        else:
            key = f"{block}.bn.{_BN_LEAVES[leaf]}"
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return sd


# ---------------------------------------------------------------------------
# flax's msgpack serialisation, read and written without flax or msgpack
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
            return self.take(self.uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.uint(1), self.take(n))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:                            # uint 8..64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                            # int 8..64
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:                            # fixext 1..16
            code = self.uint(1)
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
            return self.take(self.uint(1 << (b - 0xD9))).decode()
        if b in (0xDC, 0xDD):                            # array 16/32
            return [self.value() for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):                            # map 16/32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: unknown type byte {b:#x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def ext(code: int, payload: bytes):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code}")
        shape, dtype, buf = _Reader(payload).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float().numpy()
        else:
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(node):
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def read_flax_msgpack(data: bytes):
    """`flax.serialization.msgpack_restore`: bytes -> the tree of dicts and
    numpy arrays (chunked arrays joined)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(out)


def _pack_len(n: int, codes: Tuple[Optional[int], int, int]) -> bytes:
    """The head of a sized item: its 8-, 16- or 32-bit length form."""
    if n < 256 and codes[0] is not None:
        return bytes([codes[0], n])
    if n < 65536:
        return bytes([codes[1]]) + n.to_bytes(2, "big")
    return bytes([codes[2]]) + n.to_bytes(4, "big")


def _pack(v) -> bytes:
    if isinstance(v, dict):
        n = len(v)
        head = (bytes([0x80 | n]) if n < 16 else
                _pack_len(n, (None, 0xDE, 0xDF)))
        return head + b"".join(_pack(k) + _pack(x) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        n = len(v)
        head = (bytes([0x90 | n]) if n < 16 else
                _pack_len(n, (None, 0xDC, 0xDD)))
        return head + b"".join(_pack(x) for x in v)
    if isinstance(v, str):
        raw = v.encode()
        if len(raw) < 32:
            return bytes([0xA0 | len(raw)]) + raw
        return _pack_len(len(raw), (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(v, bytes):
        return _pack_len(len(v), (0xC4, 0xC5, 0xC6)) + v
    if isinstance(v, bool) or v is None:
        return bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[v]])
    if isinstance(v, (int, np.integer)):
        v = int(v)
        if 0 <= v < 128:
            return bytes([v])
        if -32 <= v < 0:
            return bytes([v & 0xFF])
        if v >= 0:
            return bytes([0xCF]) + v.to_bytes(8, "big")
        return bytes([0xD3]) + v.to_bytes(8, "big", signed=True)
    if isinstance(v, float):
        return bytes([0xCB]) + struct.pack(">d", v)
    if isinstance(v, (np.ndarray, np.generic)):
        # an array, or a numpy scalar packed as a 0-d array (ext type 3)
        code = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
        v = np.asarray(v)
        if v.dtype.hasobject:
            raise ValueError("msgpack: object arrays are not serialised")
        payload = _pack([list(v.shape), v.dtype.name,
                         np.ascontiguousarray(v).tobytes()])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            return bytes([fixext[len(payload)], code]) + payload
        return _pack_len(len(payload), (0xC7, 0xC8, 0xC9)) + bytes([code]) + payload
    raise TypeError(f"msgpack: cannot serialise {type(v).__name__}")


def write_flax_msgpack(tree) -> bytes:
    """`flax.serialization.msgpack_serialize` of a tree of dicts and numpy
    arrays (arrays under 1 GiB, which flax writes unchunked)."""
    return _pack(tree)


DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(__file__), "inception_v3_fid.npz")


def load_inception_params(weights_path: Optional[str] = None):
    """The flax tree of the weights file (msgpack), else of the `.pth` beside
    it (converted), else None."""
    path = weights_path or DEFAULT_WEIGHTS_PATH
    pth = path.replace(".npz", ".pth")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return read_flax_msgpack(f.read())
    if os.path.exists(pth):
        from ..utils.convert import load_torch_bin

        return convert_inception(load_torch_bin(pth))
    return None


def build_inception(tree, device="cuda") -> InceptionV3Features:
    device = resolve_device(device, "FID")
    return load_tree_(InceptionV3Features(), tree).to(device).eval()


def resize_bilinear(img: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, C] float -> [size, size, C] as `jax.image.resize(...,
    "bilinear")` gives it (antialiased when shrinking)."""
    if float(img.max()) > 1.5:
        img = img / 255.0
    return resize(img[None], (size, size), "area")[0]


def make_fid_features(weights_path: Optional[str] = None, batch: int = 8,
                      device="cuda"):
    """Returns callable(list of HWC [0,1] images) -> [N, 2048] features
    (float32 numpy), or None when no weights file exists (harness reports
    FID UNAVAILABLE). `prepare` (a chunk of host images -> the resized
    device batch) and `net` are its halves."""
    device = resolve_device(device, "FID")
    tree = load_inception_params(weights_path)
    if tree is None:
        return None
    run = network(build_inception(tree, device))

    def prepare(chunk: Sequence[np.ndarray]) -> torch.Tensor:
        with torch.no_grad(), fp32_exact():
            return torch.stack([
                resize_bilinear(torch.as_tensor(np.asarray(im, np.float32),
                                                device=device), 299)
                for im in chunk])

    def features(images: Sequence[np.ndarray]) -> np.ndarray:
        out = []
        for i in range(0, len(images), batch):
            out.append(run(prepare(images[i:i + batch])).cpu().numpy())
        return np.concatenate(out)

    features.prepare, features.net = prepare, run
    return features


def fid_dirs(dir1_images, dir2_images, features_fn) -> float:
    """Directory-level FID given two image lists and a feature extractor."""
    return fid_from_features(features_fn(dir1_images),
                             features_fn(dir2_images))
