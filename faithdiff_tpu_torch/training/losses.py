"""Training math utilities (counterpart of
`faithdiff_tpu/training/losses.py`; the reference's
`FaithDiff/training_utils.py:40-313`): SNR and min-SNR loss weights,
DREAM rectification, SD3 timestep density and loss weights. The FaithDiff
step does not call them; they are shipped as the JAX package ships them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..schedulers import DDPMScheduler


def _alphas(scheduler: DDPMScheduler, timesteps) -> torch.Tensor:
    t = torch.as_tensor(timesteps)
    return scheduler.alphas_cumprod[t.cpu()].to(t.device)


def compute_snr(scheduler: DDPMScheduler, timesteps) -> torch.Tensor:
    """SNR(t) = alpha_bar / (1 - alpha_bar)."""
    ac = _alphas(scheduler, timesteps)
    return ac / (1.0 - ac)


def min_snr_weight(scheduler: DDPMScheduler, timesteps, gamma: float = 5.0,
                   prediction_type: str = "epsilon") -> torch.Tensor:
    """min-SNR-gamma loss weights (Hang et al.)."""
    snr = compute_snr(scheduler, timesteps)
    w = torch.minimum(snr, torch.tensor(gamma))
    if prediction_type == "epsilon":
        return w / torch.clamp(snr, min=1e-8)
    if prediction_type == "v_prediction":
        return w / (snr + 1.0)
    raise ValueError(prediction_type)


def dream_rectification(scheduler: DDPMScheduler, noisy_latents: torch.Tensor,
                        timesteps, noise: torch.Tensor, eps_pred: torch.Tensor,
                        dream_detail_preservation: float = 1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DREAM (arXiv 2312.00210), epsilon prediction: move the noisy input
    and the target along the model's own (detached) error, scaled by
    sqrt(SNR)^p."""
    ac = _alphas(scheduler, timesteps).to(noisy_latents.device)
    ac = ac.reshape(ac.shape + (1,) * (noisy_latents.ndim - ac.ndim))
    sqrt_one_minus = torch.sqrt(1.0 - ac)
    dream_lambda = (ac / (1.0 - ac)) ** (0.5 * dream_detail_preservation)
    delta = (noise - eps_pred).detach() * dream_lambda
    return noisy_latents + sqrt_one_minus * delta, noise + delta


def sd3_timestep_density(batch: int, weighting_scheme: str = "logit_normal",
                         logit_mean: float = 0.0, logit_std: float = 1.0,
                         mode_scale: float = 1.29,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """u in (0, 1) with SD3's density."""
    if weighting_scheme == "logit_normal":
        u = torch.randn((batch,), generator=generator) * logit_std + logit_mean
        return torch.sigmoid(u)
    u = torch.rand((batch,), generator=generator)
    if weighting_scheme == "mode":
        return 1.0 - u - mode_scale * (torch.cos(math.pi * u / 2) ** 2 - 1 + u)
    return u


def sd3_loss_weighting(weighting_scheme: str, sigmas: torch.Tensor
                       ) -> torch.Tensor:
    """SD3 loss weights."""
    if weighting_scheme == "sigma_sqrt":
        return (sigmas ** -2.0).float()
    if weighting_scheme == "cosmap":
        bot = 1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2
        return 2.0 / (math.pi * bot)
    return torch.ones_like(sigmas)
