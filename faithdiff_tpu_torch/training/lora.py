"""The LoRA merge of the captioner's loader (counterpart of
`merge_lora` / `_scale` in `faithdiff_tpu/training/lora.py`).

An adapter is a state dict of PEFT-style keys in the port's module names,
as the JAX package's `lora_torch_state_dict` writes them:
`<p>.lora_A.weight` [r, in] and `<p>.lora_B.weight` [out, r] for each
adapted `<p>.weight` [out, in], and an optional `_alpha` scalar (default:
the rank). The merged weight is `w + (alpha / r) * B @ A` in fp32, the
reference builder's merge-and-unload (`llava/model/builder.py:86-90`).
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import torch

_A, _B = ".lora_A.weight", ".lora_B.weight"


def lora_targets(lora: Mapping[str, torch.Tensor]) -> List[str]:
    """The weight keys an adapter state dict adapts."""
    return sorted(k[:-len(_A)] + ".weight" for k in lora if k.endswith(_A))


def lora_scale(lora: Mapping[str, torch.Tensor]) -> float:
    """alpha / rank: the rank of the first adapter, alpha from `_alpha`."""
    rank = next((int(v.shape[0]) for k, v in lora.items() if k.endswith(_A)), 1)
    alpha = float(lora["_alpha"]) if "_alpha" in lora else float(rank)
    return alpha / rank


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
