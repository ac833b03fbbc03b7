"""Checkpoint / resume of a training run over torch files (counterpart of
`faithdiff_tpu/training/checkpoint.py`, which uses orbax).

`CheckpointManager` writes the whole `TrainState` a step at a time to
`<directory>/<step>/train_state.pt`: both models' parameters, the
optimizer's moments, accumulated gradient and counts, the EMA shadow and
its count, the micro-step and, when given, a generator's state (kept for
the record: a resumed run restarts its draws from `--seed`, as the JAX
runner does, so `restore` does not read it back). It
decides as orbax's `CheckpointManager` does: a save at a step at or below
the latest is skipped; otherwise the first save of a directory, and every
step that `save_interval_steps` divides, are written; `force` writes
whatever the step (and raises where that step exists); past `max_to_keep`
the oldest save goes. Files load with `torch.load(weights_only=True)`.
Under data parallelism every rank calls `save` (the sharded optimizer
state and EMA are gathered, a collective) and rank 0 alone writes; each
rank `restore`s the whole state and keeps its rows, whatever the number
of ranks that saved it.

`load_params` reads a model's safetensors directory, as
`utils/convert_cli` writes `unet/`, `denoise_encoder/` and `vae/`.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..utils.safetensors import load_dir
from .train import TrainState

_FILE = "train_state.pt"


class StepAlreadyExistsError(FileExistsError):
    pass


def _steps_on_disk(directory: str) -> List[int]:
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(
                      os.path.join(directory, d, _FILE)))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 2000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._steps = _steps_on_disk(self.directory)     # in save order

    def all_steps(self) -> List[int]:
        return list(self._steps)

    def latest_step(self) -> Optional[int]:
        return max(self._steps) if self._steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def save(self, step: int, state: TrainState, force: bool = False,
             generator: Optional[torch.Generator] = None) -> bool:
        if not force and not self.should_save(step):
            return False
        final = os.path.join(self.directory, str(step))
        if step in self._steps or os.path.exists(final):
            raise StepAlreadyExistsError(
                f"Checkpoint for step {step} already exists.")
        sd = state_to_dict(state, generator)
        writer = not dist.is_initialized() or dist.get_rank() == 0
        if writer:
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(sd, os.path.join(tmp, _FILE))
            os.replace(tmp, final)
        self._steps.append(step)
        while len(self._steps) > self.max_to_keep:
            old = os.path.join(self.directory, str(self._steps.pop(0)))
            if writer:
                shutil.rmtree(old)
        if dist.is_initialized():
            dist.barrier()          # the files are there before any rank reads
        return True

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a saved step (default: the latest) into `state` in place."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        # memory-mapped on the host and copied into the state's tensors, so
        # a stage-2 state (~52 GB) is never on the card twice
        sd = torch.load(os.path.join(self.directory, str(step), _FILE),
                        map_location="cpu", mmap=True, weights_only=True)
        load_state_dict_into(state, sd)
        return state


def state_to_dict(state: TrainState,
                  generator: Optional[torch.Generator] = None) -> dict:
    sd = {"step": state.step,
          "params": {"unet": state.unet.state_dict(),
                     "denoise_encoder": state.denoise_encoder.state_dict()},
          "opt": state.opt.state_dict(),
          "ema": {"params": state.ema_state_dict(), "step": state.ema.step}}
    if generator is not None:
        sd["generator"] = generator.get_state()
    return sd


@torch.no_grad()
def load_state_dict_into(state: TrainState, sd: dict) -> None:
    state.step = int(sd["step"])
    state.unet.load_state_dict(sd["params"]["unet"], strict=True)
    state.denoise_encoder.load_state_dict(sd["params"]["denoise_encoder"],
                                          strict=True)
    state.opt.load_state_dict(sd["opt"])
    for k, shadow in state.ema.params.items():
        whole = sd["ema"]["params"][k]
        shadow.copy_(whole if state.ema_shards is None
                     else state.ema_shards.local(k, whole))
    state.ema.step = int(sd["ema"]["step"])


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A model's state dict from a safetensors directory (what
    `utils/convert_cli` writes per model)."""
    return load_dir(os.path.abspath(path))
