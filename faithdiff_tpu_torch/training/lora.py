"""LoRA adapters (counterpart of `faithdiff_tpu/training/lora.py`).

An adapter is a dict of tensors in PEFT's keys and the port's module
names, as the JAX package's `lora_torch_state_dict` writes them:
`<m>.lora_A.weight` [r, in] and `<m>.lora_B.weight` [out, r] for each
adapted linear module `<m>`, and `_alpha` (default: the rank); the
effective weight is `w + (alpha / r) * B @ A`. The base model is frozen
and never changed: `merge_lora` folds an adapter into a state dict in fp32
(the reference builder's merge-and-unload, `llava/model/builder.py:86-90`),
and `lora_applied` adds `(alpha / r) * (x A^T) B^T` to each adapted
module's output while a forward runs, which is the merged weight's
function in another rounding order, without a merged copy of any weight
(at 13B autograd would keep every merged weight for the backward).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .train import global_norm

_A, _B = ".lora_A.weight", ".lora_B.weight"
_PEFT_PREFIX = "base_model.model."

# attention and MLP projections of the UNet (to_*), the LLaMA captioner
# (*_proj) and the transformer proj in / out: the reference's peft targets
DEFAULT_TARGETS = (
    "to_q", "to_k", "to_v", "to_out",
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
    "proj_in", "proj_out",
)


def lora_targets(lora: Mapping[str, torch.Tensor]) -> List[str]:
    """The weight keys an adapter state dict adapts."""
    return sorted(k[:-len(_A)] + ".weight" for k in lora if k.endswith(_A))


def lora_scale(lora: Mapping[str, torch.Tensor]) -> float:
    """alpha / rank: the rank of the first adapter, alpha from `_alpha`."""
    rank = next((int(v.shape[0]) for k, v in lora.items() if k.endswith(_A)), 1)
    alpha = float(lora["_alpha"]) if "_alpha" in lora else float(rank)
    return alpha / rank


def count_lora_modules(lora: Mapping[str, torch.Tensor]) -> int:
    return sum(k.endswith(_A) for k in lora)


def _is_target(name: str, module: nn.Module, targets: Sequence[str]) -> bool:
    """A linear module whose own name is a target (a flax Dense named so);
    `to_out.0` counts as `to_out`, the flax module it carries."""
    parts = name.split(".")
    own = parts[-2] if parts[-1].isdigit() and len(parts) > 1 else parts[-1]
    return isinstance(module, nn.Linear) and own in targets


def init_lora(model: nn.Module, rank: int,
              generator: Optional[torch.Generator] = None,
              targets: Sequence[str] = DEFAULT_TARGETS,
              alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """An adapter for every target linear module of `model`: A ~ N(0,
    1/rank), B zeros (so it starts as the identity), fp32, on the module's
    device; `_alpha` (default: the rank)."""
    lora: Dict[str, torch.Tensor] = {}
    for name, m in model.named_modules():
        if not _is_target(name, m, targets):
            continue
        dev = m.weight.device
        gen_dev = generator.device if generator is not None else dev
        a = torch.randn((rank, m.in_features), generator=generator,
                        dtype=torch.float32, device=gen_dev) / math.sqrt(rank)
        lora[name + _A] = a.to(dev)
        lora[name + _B] = torch.zeros((m.out_features, rank),
                                      dtype=torch.float32, device=dev)
    device = next(iter(lora.values())).device if lora else None
    lora["_alpha"] = torch.tensor(float(alpha if alpha is not None else rank),
                                  device=device)
    return lora


def _scale_tensor(lora: Mapping[str, torch.Tensor]):
    """alpha / rank with `_alpha` as a tensor, so that a gradient reaches
    it when it requires one."""
    if "_alpha" not in lora:
        return lora_scale(lora)
    rank = next(int(v.shape[0]) for k, v in lora.items() if k.endswith(_A))
    return lora["_alpha"] / rank


@contextlib.contextmanager
def lora_applied(model: nn.Module, lora: Mapping[str, torch.Tensor]):
    """While open, each adapted module of `model` returns its base output
    plus `(alpha / r) * (x A^T) B^T`, the products in the output's dtype;
    the adapter's tensors, `_alpha` included, carry whatever gradient they
    require."""
    s = _scale_tensor(lora)
    handles = []

    def hook_for(a, b):
        def hook(module, inputs, out):
            x = inputs[0]
            delta = F.linear(F.linear(x, a.to(x.dtype)), b.to(x.dtype))
            return out + (delta * s.to(delta.dtype)
                          if torch.is_tensor(s) else delta * s).to(out.dtype)
        return hook

    try:
        for key in lora:
            if key.endswith(_A):
                prefix = key[:-len(_A)]
                handles.append(model.get_submodule(prefix).register_forward_hook(
                    hook_for(lora[key], lora[prefix + _B])))
        yield model
    finally:
        for h in handles:
            h.remove()


@torch.no_grad()
def merge_lora(state_dict: Mapping[str, torch.Tensor],
               lora: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`state_dict` with `lora_scale(lora) * B @ A` added to each adapted
    weight, in fp32 on the weight's device (the merged weights come back
    fp32, the rest unchanged). An adapter whose weight is not in
    `state_dict` is passed over, as the JAX walk passes it over."""
    s = lora_scale(lora)
    out = dict(state_dict)
    for key in lora:
        if not key.endswith(_A):
            continue
        prefix = key[:-len(_A)]
        target = prefix + ".weight"
        if prefix + _B not in lora:
            raise KeyError(f"LoRA adapter {prefix}: lora_A without lora_B")
        if target not in state_dict:
            continue
        w = state_dict[target]
        a = lora[key].to(w.device, torch.float32)
        b = lora[prefix + _B].to(w.device, torch.float32)
        out[target] = w.float() + torch.matmul(b, a) * s
    return out


def lora_torch_state_dict(lora: Mapping[str, torch.Tensor],
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """The adapter's PEFT keys under `prefix` (e.g. "base_model.model."),
    `_alpha` left out as the JAX export leaves it."""
    return {prefix + k: v for k, v in lora.items() if k != "_alpha"}


def load_peft_lora(state_dict: Mapping[str, torch.Tensor],
                   alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """A PEFT-style LoRA state dict (`base_model.model.` stripped) -> an
    adapter; `_alpha` is `alpha`, else the rank of its last `lora_A`."""
    lora: Dict[str, torch.Tensor] = {}
    rank = 1
    for key, value in state_dict.items():
        key = key.replace(_PEFT_PREFIX, "")
        if key.endswith(_A):
            rank = int(value.shape[0])
        if key.endswith((_A, _B)):
            lora[key] = torch.as_tensor(value)
    lora["_alpha"] = torch.tensor(float(alpha if alpha is not None else rank))
    return lora


def make_lora_train_step(loss_from_model: Callable[[nn.Module, object], torch.Tensor],
                         model: nn.Module, update_: Callable) -> Callable:
    """step(lora, batch) -> {"loss", "grad_norm"}: the loss of `model`
    with the adapter applied, its gradient to the adapter's tensors alone
    (the base is frozen), then `update_(params, grads)` (e.g. a
    `CaptionOptimizer`'s `update_`), which changes the adapter in place.
    `grad_norm` is the norm of the gradients before the update.

    As in the JAX step, `_alpha` is one of the adapter's tensors: it has a
    gradient (zero while B is) and the update changes it."""
    model.requires_grad_(False)

    def step(lora: Dict[str, torch.Tensor], batch) -> dict:
        params = dict(lora)
        for v in params.values():
            v.requires_grad_(True)
        with lora_applied(model, lora):
            loss = loss_from_model(model, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grad_norm = global_norm(grads.values())
        for v in params.values():
            v.requires_grad_(False)
        update_(params, grads)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
