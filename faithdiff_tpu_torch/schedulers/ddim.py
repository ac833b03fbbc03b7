"""DDIM scheduler (counterpart of `faithdiff_tpu/schedulers/ddim.py`):
the deterministic eta = 0 step, and eta > 0 with noise given or drawn."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .common import step_noise
from .ddpm import DDPMScheduler


class DDIMState(NamedTuple):
    timesteps: torch.Tensor       # [S] int64, descending (CPU)
    num_inference_steps: int
    init_noise_sigma: float


class DDIMScheduler(DDPMScheduler):
    """`add_noise` and `scale_model_input` are DDPM's."""

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        return DDIMState(*super().set_timesteps(num_inference_steps))

    def step(self, state: DDIMState, model_output: torch.Tensor,
             step_index: int, sample: torch.Tensor, eta: float = 0.0,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_{t-1} = sqrt(a_prev) x0_hat + sqrt(1 - a_prev - std^2) eps
        (+ std * noise when eta > 0 and noise is given or drawn)."""
        cfg = self.cfg
        t = int(state.timesteps[step_index])
        prev_t = t - cfg.num_train_timesteps // state.num_inference_steps
        ac_t = self.alphas_cumprod[t]
        ac_prev = self._alpha_prev(prev_t)
        beta_prod_t = 1.0 - ac_t

        sample32 = sample.float()
        eps = model_output.float()
        pred_x0 = (sample32 - torch.sqrt(beta_prod_t) * eps) / torch.sqrt(ac_t)
        if cfg.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
        variance = (1.0 - ac_prev) / (1.0 - ac_t) * (1.0 - ac_t / ac_prev)
        std = eta * torch.sqrt(torch.clamp(variance, min=0))
        dir_xt = torch.sqrt(torch.clamp(1.0 - ac_prev - std ** 2, min=0)) * eps
        prev = torch.sqrt(ac_prev) * pred_x0 + dir_xt
        if eta > 0:
            noise = step_noise(sample, generator, noise)
            if noise is not None:
                prev = prev + std * noise.float()
        return prev.to(sample.dtype)
