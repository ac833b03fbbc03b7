"""Core layers shared by the models (counterpart of
`faithdiff_tpu/models/layers.py`).

Layout is NCHW inside the models. Normalisations accumulate in fp32 and
return the input dtype; parameters carry diffusers state-dict names.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.nn.utils import parametrize

from ..ops.groupnorm import group_norm
from ..ops.layernorm import layer_norm
from ..utils import profiling


def maybe_checkpoint(enabled: bool, fn, *args):
    """`fn(*args)`, under gradient checkpointing when `enabled` and autograd
    records (the flax `nn.remat` of the JAX models): the backward recomputes
    `fn`'s forward instead of keeping its activations. Values are the
    same either way."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


class _Upcast(nn.Module):
    """Parametrization that reads a stored fp8 tensor in `dtype`. While the
    recorder is on it counts each read (`fp8.upcasts`), and under a
    profiler labels the read's kernels with the range `fp8_upcast`."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, stored: torch.Tensor) -> torch.Tensor:
        if not profiling.recording_on():
            return stored.to(self.dtype)
        # counted into the span open around the call (the pipeline's `unet`)
        with profiling.leaf("fp8_upcast"):
            out = stored.to(self.dtype)
        profiling.count("fp8.upcasts")
        return out


@torch.no_grad()
def store_fp8_(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> int:
    """Hold each float8_e4m3fn entry of `state_dict` (the model's own names,
    as `utils.quantize.quantize_params_fp8` gives them) as the model's
    stored parameter, read through a parametrization that upcasts it to
    the parameter's current dtype at every access: each layer's weight
    exists in the compute dtype only while that layer runs, and fp8 ->
    bf16 is exact, so the model computes what it computes on the upcast
    weights. Returns the number of tensors stored in fp8."""
    n = 0
    for key, value in state_dict.items():
        if value.dtype != torch.float8_e4m3fn:
            continue
        module_name, _, name = key.rpartition(".")
        module = model.get_submodule(module_name)
        dtype = getattr(module, name).dtype
        module._parameters[name] = nn.Parameter(
            value.to(getattr(module, name).device), requires_grad=False)
        parametrize.register_parametrization(module, name, _Upcast(dtype),
                                             unsafe=True)
        n += 1
    return n


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal embeddings of [N] timesteps -> [N, embedding_dim] fp32
    (diffusers `get_timestep_embedding`, max period 10000)."""
    if timesteps.ndim != 1:
        raise ValueError(f"timesteps must be 1-D, got {tuple(timesteps.shape)}")
    half_dim = embedding_dim // 2
    exponent = -math.log(10000) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the information-transformer activation."""
    return x * torch.sigmoid(1.702 * x)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics, optional fused SiLU (`act`) and a
    per-(batch, channel) `add` folded in before the statistics. CUDA
    tensors run the hand-written kernel (`ops/groupnorm.py`)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor,
                add: Optional[torch.Tensor] = None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, self.act, add=add)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with single-pass fp32 statistics
    (E[x^2] - E[x]^2), returning the input dtype. CUDA tensors run the
    hand-written kernel (`ops/layernorm.py`)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP over sinusoidal embeddings."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))
