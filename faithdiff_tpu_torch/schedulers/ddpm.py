"""DDPM scheduler (counterpart of `faithdiff_tpu/schedulers/ddpm.py`):
`add_noise` (training, and the `start_point="lr"` initialisation that
noises the LR latent to t=999), the v-prediction target, and the ancestral
inference step (variance `fixed_small`, epsilon prediction, optional
`clip_sample`)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SchedulerConfig
from .common import alphas_cumprod, spaced_timesteps, step_noise


class DDPMState(NamedTuple):
    timesteps: torch.Tensor       # [S] int64, descending (CPU)
    num_inference_steps: int
    init_noise_sigma: float


def _per_sample(ac: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    ac = ac.to(like.device)
    return ac.reshape(ac.shape + (1,) * (like.ndim - ac.ndim))


class DDPMScheduler:
    order = 1

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.alphas_cumprod = torch.from_numpy(
            alphas_cumprod(cfg).astype("float32"))

    def set_timesteps(self, num_inference_steps: int) -> DDPMState:
        ts = spaced_timesteps(self.cfg, num_inference_steps)
        return DDPMState(timesteps=torch.from_numpy(ts.copy()),
                         num_inference_steps=num_inference_steps,
                         init_noise_sigma=1.0)

    def scale_model_input(self, state, sample: torch.Tensor,
                          step_index: int) -> torch.Tensor:
        return sample

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps, in fp32."""
        ac = _per_sample(self.alphas_cumprod[torch.as_tensor(timesteps)],
                         original_samples)
        out = (torch.sqrt(ac) * original_samples.float()
               + torch.sqrt(1.0 - ac) * noise.float())
        return out.to(original_samples.dtype)

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps) -> torch.Tensor:
        """v-prediction target: sqrt(a) eps - sqrt(1 - a) x0, in fp32."""
        ac = _per_sample(self.alphas_cumprod[torch.as_tensor(timesteps)],
                         sample)
        v = torch.sqrt(ac) * noise.float() - torch.sqrt(1.0 - ac) * sample.float()
        return v.to(sample.dtype)

    def _alpha_prev(self, prev_t: int) -> torch.Tensor:
        return (self.alphas_cumprod[prev_t] if prev_t >= 0
                else torch.tensor(1.0))

    def step(self, state: DDPMState, model_output: torch.Tensor,
             step_index: int, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Ancestral DDPM step. The noise is `noise`, or drawn from
        `generator`, or none (the JAX step without a key); none is added
        at t = 0."""
        cfg = self.cfg
        t = int(state.timesteps[step_index])
        prev_t = t - cfg.num_train_timesteps // state.num_inference_steps
        ac_t = self.alphas_cumprod[t]
        ac_prev = self._alpha_prev(prev_t)
        beta_prod_t = 1.0 - ac_t
        beta_prod_prev = 1.0 - ac_prev
        current_alpha = ac_t / ac_prev
        current_beta = 1.0 - current_alpha

        sample32 = sample.float()
        eps = model_output.float()
        pred_x0 = (sample32 - torch.sqrt(beta_prod_t) * eps) / torch.sqrt(ac_t)
        if cfg.clip_sample:
            pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
        pred_x0_coeff = torch.sqrt(ac_prev) * current_beta / beta_prod_t
        sample_coeff = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev = pred_x0_coeff * pred_x0 + sample_coeff * sample32

        variance = torch.clamp(beta_prod_prev / beta_prod_t * current_beta,
                               min=1e-20)
        noise = step_noise(sample, generator, noise)
        if noise is not None and t > 0:
            prev = prev + torch.sqrt(variance) * noise.float()
        return prev.to(sample.dtype)
