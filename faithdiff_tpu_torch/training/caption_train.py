"""Captioner (LLaVA-style) finetuning step (counterpart of
`faithdiff_tpu/training/caption_train.py`).

- next-token cross-entropy in fp32 over the answer span; image tokens and
  prompt masked with IGNORE_INDEX (-100);
- trainable groups: "projector" (adapter pretraining), "lm" (the LLaMA
  and the projector; the vision tower frozen) or "full", with a separate
  projector learning rate;
- the optimizer is optax's `chain(clip_by_global_norm, multi_transform(
  {"train": adamw, "proj": adamw, "freeze": set_to_zero}))`, written out
  (`CaptionOptimizer`).

The clip runs before `multi_transform`, over the WHOLE gradient: a frozen
group's gradient enters the norm, so it sets the trainable update's scale
once clipping engages, and the reported `grad_norm` includes it. So
every parameter but the vision tower's takes part in the backward; the
vision features are detached, as the JAX step's default `freeze_vision`
stops their gradient, which makes the tower's zero. A frozen
group's gradient is reduced to its sum of squares the moment autograd has
accumulated it, and freed: at 13B the whole gradient would not fit beside
the model.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping

import torch
import torch.nn as nn

from .train import adamw_, clip_by_global_norm_

IGNORE_INDEX = -100
GROUPS = ("llama", "vision", "projector")
ADAM_B1_B2_EPS = (0.9, 0.999, 1e-8)          # optax.adamw's defaults


def _label(group: str, trainable: str) -> str:
    """The optax label of a group's parameters."""
    if trainable == "projector":
        return "train" if group == "projector" else "freeze"
    if trainable == "lm":
        return "freeze" if group == "vision" else (
            "proj" if group == "projector" else "train")
    if trainable == "full":
        return "proj" if group == "projector" else "train"
    raise ValueError(f"trainable={trainable!r}: projector, lm or full")


class CaptionOptimizer:
    """optax's chain of `clip_by_global_norm(max_grad_norm)` and AdamW per
    label ("train": `learning_rate`, "proj": `projector_lr`, constant;
    "freeze": no update), in place over `params` (name -> tensor, each
    labelled by `labels`). The moments are fp32 whatever a tensor's
    dtype."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 labels: Mapping[str, str], learning_rate: float = 2e-5,
                 projector_lr: float = 2e-5, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0):
        self.labels = dict(labels)
        self.lrs = {"train": learning_rate, "proj": projector_lr}
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.trainable = [k for k in params if self.labels[k] != "freeze"]
        self.mu = {k: torch.zeros_like(params[k], dtype=torch.float32)
                   for k in self.trainable}
        self.nu = {k: torch.zeros_like(params[k], dtype=torch.float32)
                   for k in self.trainable}
        self.count = 0

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor],
                frozen_sq: torch.Tensor = None) -> torch.Tensor:
        """One step: the norm of the trainable `grads` and the frozen
        gradients' sum of squares `frozen_sq`, the clip of the trainable
        gradients (in place), AdamW on the trainable tensors. A trainable
        tensor without a gradient steps on zeros. Returns the norm."""
        grads = {k: (grads[k] if grads.get(k) is not None
                     else torch.zeros_like(params[k], dtype=torch.float32))
                 for k in self.trainable}
        sq = sum(g.float().square().sum() for g in grads.values())
        if frozen_sq is not None:
            sq = sq + frozen_sq
        g_norm = torch.sqrt(sq)
        clip_by_global_norm_(grads.values(), g_norm, self.max_grad_norm)
        self.count += 1
        for k in self.trainable:
            adamw_(params[k], grads[k].float(), self.mu[k], self.nu[k],
                   self.lrs[self.labels[k]], self.count, *ADAM_B1_B2_EPS,
                   self.weight_decay)
        return g_norm


def named_caption_params(modules: Mapping[str, nn.Module]) -> Dict[str, nn.Parameter]:
    """"<group>.<name>" -> parameter over the groups of `modules`."""
    return {f"{g}.{k}": p for g in GROUPS
            for k, p in modules[g].named_parameters()}


def make_caption_optimizer(modules: Mapping[str, nn.Module],
                           trainable: str = "projector",
                           learning_rate: float = 2e-5,
                           projector_lr: float = 2e-5,
                           weight_decay: float = 0.0,
                           max_grad_norm: float = 1.0) -> CaptionOptimizer:
    """The optimizer over `modules` ({"llama", "vision", "projector"})
    with each group labelled as `trainable` says."""
    params = named_caption_params(modules)
    labels = {k: _label(k.split(".", 1)[0], trainable) for k in params}
    return CaptionOptimizer(params, labels, learning_rate, projector_lr,
                            weight_decay, max_grad_norm)


@dataclasses.dataclass
class CaptionTrainState:
    step: int
    modules: Dict[str, nn.Module]       # {"llama", "vision", "projector"}
    opt: CaptionOptimizer


def caption_loss(llama: nn.Module, vision: nn.Module, projector: nn.Module,
                 batch: Mapping[str, torch.Tensor], image_token_pos: int
                 ) -> torch.Tensor:
    """The image span spliced over the placeholder at `image_token_pos`,
    then next-token cross-entropy in fp32 over the labels that are not
    IGNORE_INDEX. batch: input_ids [B, S], labels [B, S], pixels
    [B, H, W, 3] (NHWC, CLIP-normalised), on the models' device."""
    ids = batch["input_ids"]
    b, s = ids.shape
    embeds = llama.embed(ids)
    img = projector(vision(batch["pixels"]).detach()).to(embeds.dtype)
    n = img.shape[1]
    embeds = torch.cat([embeds[:, :image_token_pos], img,
                        embeds[:, image_token_pos + n:]], dim=1)
    positions = torch.arange(s, device=ids.device)[None].expand(b, s)
    logits, _ = llama(embeds, positions)
    logits = logits[:, :-1]
    labels = batch["labels"][:, 1:]
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


@contextlib.contextmanager
def _frozen_grads_to_squares(params: Mapping[str, nn.Parameter],
                             frozen: List[str]):
    """While open, each frozen parameter's accumulated gradient is added
    to a sum of squares (yielded, a list of scalars) and freed at once."""
    squares: List[torch.Tensor] = []

    def hook(p):
        squares.append(p.grad.float().square().sum())
        p.grad = None

    handles = [params[k].register_post_accumulate_grad_hook(hook)
               for k in frozen if params[k].requires_grad]
    try:
        yield squares
    finally:
        for h in handles:
            h.remove()


def make_caption_train_step(image_token_pos: int,
                            compute_dtype: torch.dtype = torch.float32):
    """Returns step(state, batch) -> {"loss", "grad_norm"}, one optimizer
    step in place on `state` (the JAX step's `tx.update` and
    `apply_updates`). The forward runs under autocast at `compute_dtype`
    when that is not fp32 (the card: a bf16 LLaMA, fp32 trainable
    tensors)."""

    def step(state: CaptionTrainState, batch) -> dict:
        m = state.modules
        params = named_caption_params(m)
        frozen = [k for k in params if k not in state.opt.mu]
        for k, p in params.items():
            p.requires_grad_(not k.startswith("vision."))
            p.grad = None
        device = next(m["llama"].parameters()).device
        with _frozen_grads_to_squares(params, frozen) as squares:
            with torch.autocast(device.type, dtype=compute_dtype,
                                enabled=compute_dtype != torch.float32):
                loss = caption_loss(m["llama"], m["vision"], m["projector"],
                                    batch, image_token_pos)
            loss.backward()
        grads = {k: params[k].grad for k in state.opt.trainable}
        frozen_sq = torch.stack(squares).sum() if squares else None
        grad_norm = state.opt.update_(params, grads, frozen_sq)
        for p in params.values():
            p.grad = None
            p.requires_grad_(False)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
