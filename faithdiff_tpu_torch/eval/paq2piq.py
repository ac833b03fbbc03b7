"""PaQ-2-PiQ (Ying et al. 2020, "From Patches to Pictures"; counterpart of
`faithdiff_tpu/eval/paq2piq.py`).

The published RoIPoolModel: a ResNet-18 trunk (ImageNet-normalised input,
BatchNorm running statistics applied at inference) followed by the
fastai-style head: concat of global max- and average-pooled features,
BatchNorm1d, Linear(1024, 512), ReLU, BatchNorm1d, Linear(512, 1).

The picture-level score is the head over the whole feature map; patch
scores (the paper's RoI branch) come from `roi_scores`, which pools the
same trunk features over an aligned box grid by slicing, in plain torch
(no RoIPool op).

Weights-gated: `convert_paq2piq` maps the torch RoIPoolModel layout
(`body.*` torchvision ResNet-18 children, `head.*` sequential indices) to
the JAX harness's flat npz, which `make_paq2piq` reads.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .lpips import (_to_numpy, load_lpips_params, load_tree_, network,
                    resolve_device)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# ResNet-18: 4 stages x 2 BasicBlocks; first block of stages 2-4 strides 2
_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


class _BN(nn.Module):
    """Inference BatchNorm over dim 1: (x - mean) / sqrt(var + eps) * scale
    + bias, the running statistics held as parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        v = lambda p: p.view(shape)  # noqa: E731
        return (x - v(self.mean)) * torch.rsqrt(v(self.var) + self.eps) \
            * v(self.scale) + v(self.bias)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = _BN(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _BN(features)
        if stride != 1 or cin != features:
            self.down_conv = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.down_bn = _BN(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class ResNet18Trunk(nn.Module):
    """torchvision ResNet-18 cut before the classifier (children[:-2]):
    NHWC [B, H, W, 3] in [0, 1] -> NCHW [B, 512, H/32, W/32]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _BN(64)
        cin = 64
        for s, (ch, stride) in enumerate(_STAGES):
            for b in range(2):
                self.add_module(f"layer{s + 1}_{b}",
                                _BasicBlock(cin, ch, stride if b == 0 else 1))
                cin = ch
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        x = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(len(_STAGES)):
            for b in range(2):
                x = getattr(self, f"layer{s + 1}_{b}")(x)
        return x


class PaQ2PiQHead(nn.Module):
    """fastai head: [max-pool ++ avg-pool] -> BN -> FC(512) -> ReLU -> BN
    -> FC(1). Dropout is inference-off."""

    def __init__(self):
        super().__init__()
        self.bn0 = _BN(1024)
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = _BN(512)
        self.fc2 = nn.Linear(512, 1)

    def forward(self, feats):
        x = torch.cat([feats.amax(dim=(2, 3)), feats.mean(dim=(2, 3))], dim=-1)
        x = F.relu(self.fc1(self.bn0(x)))
        return self.fc2(self.bn1(x))[:, 0]


class PaQ2PiQ(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = ResNet18Trunk()
        self.head = PaQ2PiQHead()

    def forward(self, x):
        """x: [B, H, W, 3] in [0, 1]. Returns [B] picture-level quality
        (the published model outputs roughly a 0-100 MOS scale)."""
        return self.head(self.body(x))


def roi_scores(params: Mapping, image: np.ndarray,
               grid: Tuple[int, int] = (4, 4), device="cuda") -> np.ndarray:
    """Patch-level qualities: trunk features pooled per grid cell through
    the same head (the paper's RoIPool branch on an aligned grid).
    `params` is the flax tree (`body`, `head`)."""
    model = build_paq2piq(params, device)
    run = network(model.body)
    feats = run(torch.as_tensor(np.asarray(image, np.float32),
                                device=model.head.fc1.weight.device)[None])
    _, _, fh, fw = feats.shape
    gh, gw = grid
    rows = np.linspace(0, fh, gh + 1).astype(int)
    cols = np.linspace(0, fw, gw + 1).astype(int)
    head = network(model.head)
    out = np.zeros(grid, np.float32)
    for i in range(gh):
        for j in range(gw):
            cell = feats[:, :, rows[i]:max(rows[i] + 1, rows[i + 1]),
                         cols[j]:max(cols[j] + 1, cols[j + 1])]
            out[i, j] = float(head(cell)[0])
    return out


def convert_paq2piq(state_dict: Dict) -> Dict:
    """torch RoIPoolModel -> the flax tree. `body.{0,1}` = stem conv/bn,
    `body.{4..7}.{0,1}` = stages, `.downsample.{0,1}` = shortcut;
    `head.{1,3,5,7}` = BN1d / Linear / BN1d / Linear (fastai indices with
    flatten+dropout interleaved)."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}

    def bn(prefix):
        return {"scale": sd[f"{prefix}.weight"],
                "bias": sd[f"{prefix}.bias"],
                "mean": sd[f"{prefix}.running_mean"],
                "var": sd[f"{prefix}.running_var"]}

    def conv(key):
        return {"kernel": sd[key].transpose(2, 3, 1, 0)}

    body: Dict = {"conv1": conv("body.0.weight"), "bn1": bn("body.1")}
    for s in range(4):
        for b in range(2):
            p = f"body.{4 + s}.{b}"
            blk = {"conv1": conv(f"{p}.conv1.weight"), "bn1": bn(f"{p}.bn1"),
                   "conv2": conv(f"{p}.conv2.weight"), "bn2": bn(f"{p}.bn2")}
            if f"{p}.downsample.0.weight" in sd:
                blk["down_conv"] = conv(f"{p}.downsample.0.weight")
                blk["down_bn"] = bn(f"{p}.downsample.1")
            body[f"layer{s + 1}_{b}"] = blk

    # fastai head indices: 0 concat-pool, 1 BN1d, 2 dropout, 3 linear,
    # 4 relu, 5 BN1d, 6 dropout, 7 linear (a flatten shifts some exports
    # by one: found by tensor shapes instead of hardcoded)
    lin_keys = sorted(
        {int(k.split(".")[1]) for k in sd
         if k.startswith("head.") and k.endswith(".weight")
         and sd[k].ndim == 2})
    bn_keys = sorted(
        {int(k.split(".")[1]) for k in sd
         if k.startswith("head.") and f"head.{k.split('.')[1]}.running_mean"
         in sd})
    assert len(lin_keys) == 2 and len(bn_keys) == 2, (lin_keys, bn_keys)
    head = {
        "bn0": bn(f"head.{bn_keys[0]}"),
        "fc1": {"kernel": sd[f"head.{lin_keys[0]}.weight"].T,
                "bias": sd[f"head.{lin_keys[0]}.bias"]},
        "bn1": bn(f"head.{bn_keys[1]}"),
        "fc2": {"kernel": sd[f"head.{lin_keys[1]}.weight"].T,
                "bias": sd[f"head.{lin_keys[1]}.bias"]},
    }
    return {"body": body, "head": head}


_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "paq2piq.npz")


def build_paq2piq(tree: Mapping, device="cuda") -> PaQ2PiQ:
    device = resolve_device(device, "PaQ-2-PiQ")
    return load_tree_(PaQ2PiQ(), tree).to(device).eval()


def make_paq2piq(weights_path: Optional[str] = None, device="cuda"):
    """PaQ-2-PiQ callable `(img [H, W, 3] in [0,1]) -> float` on `device`,
    or None when no converted weights exist (harness reports
    UNAVAILABLE); `prepare` and `net` are its halves."""
    device = resolve_device(device, "PaQ-2-PiQ")
    path = weights_path or _DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None
    run = network(build_paq2piq(load_lpips_params(path), device))

    def prepare(img: np.ndarray):
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return (torch.as_tensor(np.asarray(img, np.float32), device=device)[None],)

    def call(img: np.ndarray) -> float:
        return float(run(*prepare(img))[0])

    call.prepare, call.net = prepare, run
    return call
