from .common import alphas_cumprod, make_betas, spaced_timesteps
from .ddim import DDIMScheduler, DDIMState
from .ddpm import DDPMScheduler, DDPMState
from .euler import (EulerAncestralDiscreteScheduler, EulerDiscreteScheduler,
                    EulerState)

__all__ = [
    "alphas_cumprod", "make_betas", "spaced_timesteps",
    "DDIMScheduler", "DDIMState",
    "DDPMScheduler", "DDPMState",
    "EulerDiscreteScheduler", "EulerAncestralDiscreteScheduler", "EulerState",
]
