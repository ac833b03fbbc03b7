"""EMA of the trainable parameters (counterpart of
`faithdiff_tpu/training/ema.py`).

The reference's `EMAModel` (`FaithDiff/training_utils.py`): a warmup
decay schedule, interval gating, and a copy of the shadow into the model
for validation. The shadow is fp32 and covers the trainable parameters
only, keyed by their names in the model's state dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]     # name -> fp32 shadow
    step: int = 0                       # updates applied so far


def ema_init(params: Mapping[str, torch.Tensor]) -> EMAState:
    return EMAState({k: p.detach().float().clone() for k, p in params.items()})


def ema_decay_for_step(step: int, decay: float = 0.9999,
                       min_decay: float = 0.0, update_after_step: int = 0,
                       use_ema_warmup: bool = True, inv_gamma: float = 1.0,
                       power: float = 2.0 / 3.0) -> float:
    """Warmup decay schedule (`training_utils.py:500-520`), in fp32 as the
    JAX package computes it."""
    s = torch.tensor(float(max(step - update_after_step - 1, 0)))
    if use_ema_warmup:
        cur = 1.0 - (1.0 + s / inv_gamma) ** -power
    else:
        cur = (1.0 + s) / (10.0 + s)
    if s <= 0:
        cur = torch.tensor(0.0)
    return float(torch.clamp(cur, min_decay, decay))


@torch.no_grad()
def ema_update(state: EMAState, new_params: Mapping[str, torch.Tensor],
               global_step: int, interval: int = 1, decay: float = 0.9999,
               **decay_kwargs) -> EMAState:
    """Interval-gated update in place (`training_utils.py:305-313`): only
    a step with `global_step % interval == 0` moves the shadow,
    shadow - (1 - d) * (shadow - p)."""
    if global_step % interval:
        return state
    d = torch.tensor(ema_decay_for_step(state.step, decay=decay,
                                        **decay_kwargs))
    one_minus = 1.0 - d
    for name, shadow in state.params.items():
        shadow.sub_(one_minus * (shadow - new_params[name].float()))
    state.step += 1
    return state


@torch.no_grad()
def ema_copy_to(state: EMAState, like: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """`like` (a state dict) with the shadow in place of its trainable
    entries, each cast to the entry's dtype; frozen entries stay as they
    are (the validation swap, `training_utils.py:704-729`)."""
    return {k: (state.params[k].to(v.dtype) if k in state.params else v)
            for k, v in like.items()}
