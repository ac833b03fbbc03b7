"""Euler discrete schedulers, the SDXL default and its ancestral variant
(counterpart of `faithdiff_tpu/schedulers/euler.py`).

State is an explicit `EulerState`; the plain `step` is deterministic, so
stepping a batch of tiles is one call with one shared state and the step
index. `use_karras_sigmas` spaces the sigmas as Karras et al. (rho = 7)
between the spaced schedule's extremes and maps each back to a fractional
timestep by log-sigma interpolation (diffusers' `_sigma_to_t`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SchedulerConfig
from .common import alphas_cumprod, spaced_timesteps, step_noise


class EulerState(NamedTuple):
    timesteps: torch.Tensor       # [S] float32, descending (CPU)
    sigmas: torch.Tensor          # [S+1] float32, terminal 0 appended (CPU)
    num_inference_steps: int
    init_noise_sigma: float


class EulerDiscreteScheduler:
    order = 1

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        ac = alphas_cumprod(cfg)
        self._sigmas_train = np.sqrt((1.0 - ac) / ac)

    def set_timesteps(self, num_inference_steps: int) -> EulerState:
        cfg = self.cfg
        timesteps = spaced_timesteps(cfg, num_inference_steps).astype(np.float64)
        sigmas = np.interp(timesteps, np.arange(len(self._sigmas_train)),
                           self._sigmas_train)
        if cfg.use_karras_sigmas:
            sigmas = self._karras_sigmas(sigmas, num_inference_steps)
            timesteps = np.array([self._sigma_to_t(s) for s in sigmas],
                                 dtype=np.float64)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        max_sigma = float(sigmas.max())
        if cfg.timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = max_sigma
        else:
            init_noise_sigma = (max_sigma ** 2 + 1) ** 0.5
        return EulerState(
            timesteps=torch.tensor(timesteps, dtype=torch.float32),
            sigmas=torch.from_numpy(sigmas),
            num_inference_steps=num_inference_steps,
            init_noise_sigma=float(np.float32(init_noise_sigma)))

    @staticmethod
    def _karras_sigmas(in_sigmas: np.ndarray, n: int) -> np.ndarray:
        sigma_min, sigma_max = in_sigmas[-1], in_sigmas[0]
        rho = 7.0
        ramp = np.linspace(0, 1, n)
        min_inv_rho = sigma_min ** (1 / rho)
        max_inv_rho = sigma_max ** (1 / rho)
        return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho

    def _sigma_to_t(self, sigma: float) -> float:
        log_sigma = np.log(np.maximum(sigma, 1e-10))
        log_sigmas = np.log(self._sigmas_train)
        dists = log_sigma - log_sigmas[:, None]
        low_idx = np.cumsum(dists >= 0, axis=0).argmax(axis=0).clip(
            max=len(log_sigmas) - 2)[0]
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = np.clip((low - log_sigma) / (low - high), 0, 1)
        return float((1 - w) * low_idx + w * high_idx)

    def scale_model_input(self, state: EulerState, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        sigma = state.sigmas[step_index]
        return (sample.float() / torch.sqrt(sigma ** 2 + 1)).to(sample.dtype)

    def step(self, state: EulerState, model_output: torch.Tensor,
             step_index: int, sample: torch.Tensor) -> torch.Tensor:
        """One deterministic Euler step, x += eps * (sigma_next - sigma)
        (epsilon prediction)."""
        dt = state.sigmas[step_index + 1] - state.sigmas[step_index]
        prev = sample.float() + model_output.float() * dt
        return prev.to(sample.dtype)


class EulerAncestralDiscreteScheduler(EulerDiscreteScheduler):
    """Ancestral variant (diffusers `EulerAncestralDiscreteScheduler`): a
    step to sigma_down plus fresh noise at sigma_up. The noise is `noise`
    (e.g. the JAX step's draw in a test), or N(0, 1) from `generator`, or
    none when neither is given (as the JAX step without a key)."""

    def step(self, state: EulerState, model_output: torch.Tensor,
             step_index: int, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        sigma = state.sigmas[step_index]
        sigma_to = state.sigmas[step_index + 1]
        sigma_up = torch.sqrt(torch.clamp(
            sigma_to ** 2 * (sigma ** 2 - sigma_to ** 2) / sigma ** 2, min=0))
        sigma_down = torch.sqrt(torch.clamp(sigma_to ** 2 - sigma_up ** 2,
                                            min=0))
        prev = sample.float() + model_output.float() * (sigma_down - sigma)
        noise = step_noise(sample, generator, noise)
        if noise is not None:
            prev = prev + noise.float() * sigma_up
        return prev.to(sample.dtype)
