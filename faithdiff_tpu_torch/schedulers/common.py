"""Shared diffusion-schedule math (counterpart of
`faithdiff_tpu/schedulers/common.py`), in numpy float64."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SchedulerConfig


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(cfg.num_train_timesteps + 1,
                      dtype=np.float64) / cfg.num_train_timesteps
        alpha_bar = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        return np.clip(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")


def alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(cfg), axis=0)


def spaced_timesteps(cfg: SchedulerConfig,
                     num_inference_steps: int) -> np.ndarray:
    """Inference timesteps in descending order (diffusers semantics of
    `timestep_spacing`)."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_inference_steps, dtype=np.float64)[::-1]
        return np.round(ts).astype(np.int64)
    if cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        return (ts + cfg.steps_offset).astype(np.int64)
    if cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        return (np.round(np.arange(n, 0, -step_ratio)) - 1).astype(np.int64)
    raise ValueError(f"unknown timestep spacing {cfg.timestep_spacing!r}")


def step_noise(sample: torch.Tensor, generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A stochastic step's N(0, 1): `noise` if given, else drawn from
    `generator` on the generator's device, else None."""
    if noise is not None:
        return noise.to(sample.device)
    if generator is None:
        return None
    return torch.randn(sample.shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(sample.device)
