"""LPIPS (Learned Perceptual Image Patch Similarity), and the weight files
every learned metric of the port shares (counterpart of
`faithdiff_tpu/eval/lpips.py`).

The metric network (Zhang et al. 2018): a frozen AlexNet or VGG16 feature
backbone, per-layer unit normalisation, squared feature differences
weighted by learned 1x1 linear heads, spatially averaged and summed over
stages. Weights-gated: without `lpips_<net>.npz` (built by
`convert_lpips` from the torchvision backbone + LPIPS linear-head state
dicts) `make_lpips` returns None and the harness reports
`UNAVAILABLE: no LPIPS weights`.

The weight files are the JAX harness's: a flat npz whose keys are the
flax parameter paths joined by `/` (`load_lpips_params` /
`save_lpips_params`). The port's modules carry the flax module names, so a
state-dict key is the flax path joined by `.`, with the leaf renamed
where torch names it otherwise: a conv or dense `kernel` is the module's
`weight` (HWIO <-> OIHW, [in, out] <-> [out, in]), a LayerNorm `scale` its
`weight`, an `Embed`'s `embedding` its `weight`; every other leaf keeps its
name and layout (`state_dict_from_tree`, `tree_from_module`). The networks
compute in fp32 with TF32 off (`fp32_exact`), as the JAX CPU harness and
pyiqa do.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import LayerNorm
from ..utils.convert import _flatten

# input scaling (the lpips package's ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# conv definitions per backbone: (out_ch, kernel, stride, maxpool_before)
_ALEX = [(64, 11, 4, False), (192, 5, 1, True), (384, 3, 1, True),
         (256, 3, 1, False), (256, 3, 1, False)]
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


# ---------------------------------------------------------------------------
# shared by the learned metrics: device, precision, the flax layout
# ---------------------------------------------------------------------------

def resolve_device(device, what: str) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent
    (the port's entry points run on the card unless told otherwise)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device 'cuda' requested but CUDA is not "
                           f"available (pass device='cpu' to run on the CPU)")
    return device


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and cuDNN convolutions inside the block, the
    previous settings restored after it (a restore in the same process
    keeps its own)."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def network(model: nn.Module) -> Callable:
    """`model`'s forward without autograd, in fp32 with TF32 off."""
    def run(*args):
        with torch.no_grad(), fp32_exact():
            return model(*args)
    return run


_KERNEL_MODULES = (nn.Conv2d, nn.Linear)
_SCALE_MODULES = (LayerNorm, nn.LayerNorm)


def _default_path(key: str, owner: nn.Module) -> Tuple[str, ...]:
    *mods, leaf = key.split(".")
    if leaf == "weight":
        if isinstance(owner, _KERNEL_MODULES):
            leaf = "kernel"
        elif isinstance(owner, _SCALE_MODULES):
            leaf = "scale"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
    return tuple(mods) + (leaf,)


def _entries(module: nn.Module, rename) -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """state-dict key -> (flax path, layout): "conv" (OIHW <-> HWIO),
    "dense" (transposed) or "raw"."""
    owners = dict(module.named_modules())
    out = {}
    for key in module.state_dict():
        owner = owners[key.rpartition(".")[0]]
        layout = "raw"
        if key.endswith(".weight") and isinstance(owner, nn.Conv2d):
            layout = "conv"
        elif key.endswith(".weight") and isinstance(owner, nn.Linear):
            layout = "dense"
        path = _default_path(key, owner)
        out[key] = (tuple(rename(path)) if rename else path, layout)
    return out


def state_dict_from_tree(module: nn.Module, tree: Mapping,
                         rename: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested dicts of arrays, no "params" level) ->
    `module`'s state dict, fp32. `rename` maps a default flax path (the
    key's parts with the leaf renamed) to the tree's. Raises KeyError on a
    leaf either side lacks."""
    flat = dict(_flatten(tree))
    out, used = {}, set()
    for key, (path, layout) in _entries(module, rename).items():
        if path not in flat:
            raise KeyError(f"weights lack {'/'.join(path)} (for {key})")
        used.add(path)
        arr = np.asarray(flat[path], np.float32)
        if layout == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        elif layout == "dense":
            arr = arr.T
        out[key] = torch.from_numpy(np.array(arr, order="C"))   # 0-d stays 0-d
    extra = sorted("/".join(p) for p in set(flat) - used)
    if extra:
        raise KeyError(f"weights hold leaves the model lacks: {extra[:8]}")
    return out


def load_tree_(module: nn.Module, tree: Mapping,
               rename: Optional[Callable] = None) -> nn.Module:
    """`module` with the tree's weights, loaded strictly (a shape the model
    does not have raises)."""
    module.load_state_dict(state_dict_from_tree(module, tree, rename), strict=True)
    return module


def tree_from_module(module: nn.Module,
                     rename: Optional[Callable] = None) -> Dict:
    """The inverse of `state_dict_from_tree`: `module`'s parameters as the
    flax tree the JAX harness loads (fp32 numpy)."""
    sd = module.state_dict()
    tree: Dict = {}
    for key, (path, layout) in _entries(module, rename).items():
        arr = sd[key].detach().float().cpu().numpy()
        if layout == "conv":
            arr = arr.transpose(2, 3, 1, 0)
        elif layout == "dense":
            arr = arr.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr, order="C")
    return tree


def config_from_blob(cls, blob):
    """A frozen config dataclass from a weights file's `_config` JSON (lists
    become tuples)."""
    raw = json.loads(str(np.asarray(blob)))
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items()})


def seeded_init_(module: nn.Module, seed: int,
                 positive: Tuple[str, ...] = ()) -> nn.Module:
    """Seeded weights at the layers' published shapes, for runs without the
    released files: fan-in scaled normal conv / dense weights, norm scales
    near 1, BatchNorm running variances in [0.5, 1.5), N(0, 0.02) for the
    rest (biases, running means, embeddings and tables), and U(0.1, 1) for
    the leaves whose name starts with one of `positive` (weights a metric
    takes as non-negative)."""
    g = torch.Generator().manual_seed(seed)
    owners = dict(module.named_modules())
    with torch.no_grad():
        for key, t in module.state_dict().items():
            owner = owners[key.rpartition(".")[0]]
            leaf = key.rpartition(".")[2]
            if leaf.startswith(positive) and positive:
                v = 0.1 + 0.9 * torch.rand(t.shape, generator=g)
            elif leaf == "weight" and isinstance(owner, _KERNEL_MODULES):
                v = torch.randn(t.shape, generator=g) * (1.0 / t[0].numel()) ** 0.5
            elif (leaf in ("scale", "bn_scale")
                  or leaf == "weight" and isinstance(owner, _SCALE_MODULES)):
                v = 1.0 + 0.1 * torch.randn(t.shape, generator=g)
            elif leaf.endswith("var"):
                v = 0.5 + torch.rand(t.shape, generator=g)
            else:
                v = 0.02 * torch.randn(t.shape, generator=g)
            t.copy_(v.to(t.dtype))
    return module


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

class AlexFeatures(nn.Module):
    """AlexNet.features truncated at each ReLU stage (5 taps), NCHW."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, _) in enumerate(_ALEX):
            pad = (k - 1) // 2 if k != 11 else 2
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, k, s, pad))
            cin = ch

    def forward(self, x):
        taps = []
        for i, (_, _, _, pool_before) in enumerate(_ALEX):
            if pool_before:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
        return taps


class VGG16Features(nn.Module):
    """VGG16 features with taps at relu{1_2,2_2,3_3,4_3,5_3}, NCHW."""

    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for ch, n_convs in _VGG_STAGES:
            for _ in range(n_convs):
                self.add_module(f"conv{idx}", nn.Conv2d(cin, ch, 3, 1, 1))
                cin, idx = ch, idx + 1

    def forward(self, x):
        taps, idx = [], 0
        for stage, (_, n_convs) in enumerate(_VGG_STAGES):
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            taps.append(x)
            if stage != len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


_TAP_CHANNELS = {"alex": [c for c, *_ in _ALEX],
                 "vgg": [c for c, _ in _VGG_STAGES]}


class LPIPS(nn.Module):
    """Backbone taps -> unit-norm -> lin heads -> spatial mean, summed."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        self.backbone = AlexFeatures() if net == "alex" else VGG16Features()
        for i, c in enumerate(_TAP_CHANNELS[net]):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, a, b):
        """a, b: [B, H, W, 3] in [-1, 1]. Returns [B] distances."""
        def feats(x):
            x = x.permute(0, 3, 1, 2)
            return self.backbone((x - self.shift) / self.scale)

        total = 0.0
        for i, (xa, xb) in enumerate(zip(feats(a), feats(b))):
            na = xa / torch.sqrt(xa.square().sum(dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(xb.square().sum(dim=1, keepdim=True) + 1e-10)
            w = torch.clamp(getattr(self, f"lin{i}"), min=0.0)
            d = ((na - nb).square() * w[None, :, None, None]).sum(dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_lpips(backbone_sd: Dict, lin_sd: Dict, net: str = "alex") -> Dict:
    """(torchvision backbone state dict, lpips lin state dict) -> the flax
    tree. backbone keys: `features.N.weight/bias` (torchvision
    AlexNet/VGG16); lin keys: `lin{i}.model.1.weight` ([1, C, 1, 1])."""
    convs = {}
    conv_idx = 0
    n_convs = 5 if net == "alex" else 13
    for key in sorted(backbone_sd, key=lambda k: int(k.split(".")[1])):
        w = _to_numpy(backbone_sd[key])
        if not key.endswith(".weight") or w.ndim != 4:
            continue
        bkey = key[:-len("weight")] + "bias"
        convs[f"conv{conv_idx}"] = {
            "kernel": w.transpose(2, 3, 1, 0),  # OIHW -> HWIO
            "bias": _to_numpy(backbone_sd[bkey]),
        }
        conv_idx += 1
    assert conv_idx == n_convs, f"expected {n_convs} convs, got {conv_idx}"
    params = {"backbone": convs}
    for i in range(5):
        params[f"lin{i}"] = _to_numpy(lin_sd[f"lin{i}.model.1.weight"]).reshape(-1)
    return params


_DEFAULT_WEIGHTS = {
    "alex": os.path.join(os.path.dirname(__file__), "lpips_alex.npz"),
    "vgg": os.path.join(os.path.dirname(__file__), "lpips_vgg.npz"),
}


def load_lpips_params(path: str) -> Dict:
    """A flat `/`-keyed npz -> the nested flax tree."""
    flat = np.load(path)
    params: Dict = {}
    for key, value in flat.items():
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return params


def save_lpips_params(params: Dict, path: str) -> None:
    """The nested flax tree -> a flat `/`-keyed npz."""
    flat = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params)
    np.savez(path, **flat)


def build_lpips(tree: Mapping, net: str = "alex", device="cuda") -> LPIPS:
    device = resolve_device(device, "LPIPS")
    return load_tree_(LPIPS(net), tree).to(device).eval()


def make_lpips(weights_path: Optional[str] = None, net: str = "alex",
               device="cuda"):
    """LPIPS callable `(img, ref in [0,1] HWC/NHWC) -> float` on `device`,
    or None when no weights exist (harness reports UNAVAILABLE). The
    callable's `prepare` (host arrays -> device tensors) and `net` (the
    network) are its two halves."""
    device = resolve_device(device, "LPIPS")
    path = weights_path or _DEFAULT_WEIGHTS[net]
    if not os.path.exists(path):
        return None
    run = network(build_lpips(load_lpips_params(path), net, device))

    def prepare(img: np.ndarray, ref: np.ndarray):
        if img.ndim == 3:
            img, ref = img[None], ref[None]
        a = torch.as_tensor(np.asarray(img, np.float32), device=device) * 2.0 - 1.0
        b = torch.as_tensor(np.asarray(ref, np.float32), device=device) * 2.0 - 1.0
        return a, b

    def call(img: np.ndarray, ref: np.ndarray) -> float:
        return float(run(*prepare(img, ref))[0])

    call.prepare, call.net = prepare, run
    return call
