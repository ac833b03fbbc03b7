"""Two-stage FaithDiff training step (counterpart of
`faithdiff_tpu/training/train.py`).

- stage 1 (alignment) trains only the fusion adapters after `conv_in`:
  `condition_embedding` and the information transformer (whose layers and
  output projection the state dict names `information_transformer_layes.*`
  and `spatial_ch_projs.*`);
- stage 2 (joint) trains the denoise encoder at `vis_learning_rate` and
  the whole UNet at `learning_rate`;
- loss: L1 on epsilon in fp32, uniform timesteps, a per-(batch, channel)
  noise offset; the optimizer is optax's chain, written out:
  `clip_by_global_norm` over every trainable tensor, AdamW per group with
  its own warmup-cosine schedule, and under `grad_accum > 1` optax's
  `MultiSteps` (the running mean of k micro-steps' gradients, an update
  at every k-th); an interval-gated fp32 EMA of the trainable tensors.

Frozen parameters have `requires_grad` off: no gradient, no optimizer
state and no EMA shadow exist for them. The accumulated gradient of
`MultiSteps` is each trainable parameter's `.grad`: a hook turns a
micro-step's gradient g into (g - acc) / (n + 1) before autograd adds it,
which is optax's running mean with no second gradient buffer.

Mixed precision: fp32 master parameters, the forward in bf16 under
`torch.autocast` (`compute_dtype`), as flax's `dtype=bfloat16` modules
over fp32 parameters compute in the JAX runner; `compute_dtype=float32`
runs the forward in fp32 (the flash kernels have an fp32 instance).

Data parallelism with ZeRO (`init_train_state(..., data_parallel=True)`,
the JAX runner's mesh and shardings over the default process group): each
rank's micro-steps see its slice of the batch; at each optimizer step the
accumulated gradients are averaged over the ranks, the global norm for
clipping is all-reduced over the parts each rank owns, and each rank
updates its rows of every tensor that `parallel.mesh.LeadingShards`
shards (AdamW moments kept for those rows only) and all-gathers the
parameters; the EMA shadow is sharded as well at stage 2 (replicated at
stage 1, as in JAX). Every rank keeps the whole parameters: the forward
needs the whole UNet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..config import SchedulerConfig, TrainConfig
from ..models.vae import sample_from_moments
from ..parallel.mesh import LeadingShards
from ..schedulers import DDPMScheduler
from ..utils.profiling import span
from .ema import EMAState, ema_init, ema_update

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's `warmup_cosine_decay_schedule`: linear from `init_value` to
    `peak_value` over `warmup_steps`, then a cosine to `end_value` over
    the remaining `decay_steps - warmup_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"cosine decay needs positive steps, got {cosine_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def make_lr_schedule(cfg: TrainConfig) -> Schedule:
    if cfg.lr_scheduler == "cosine":
        return warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.lr_warmup_steps,
            max(cfg.max_train_steps, cfg.lr_warmup_steps + 1))
    if cfg.lr_scheduler == "constant":
        return constant_schedule(cfg.learning_rate)
    raise ValueError(cfg.lr_scheduler)


def make_vis_schedule(cfg: TrainConfig) -> Schedule:
    """The denoise encoder's schedule: warmup-cosine whatever
    `lr_scheduler` says, as in the JAX package."""
    return warmup_cosine_decay_schedule(
        0.0, cfg.vis_learning_rate, cfg.lr_warmup_steps,
        max(cfg.max_train_steps, cfg.lr_warmup_steps + 1))


# the JAX UNet's top-level modules that stage 1 trains
_ADAPTER_KEYS = ("condition_embedding", "information_transformer")
# port names whose flax module is the information transformer
_INFO_TRANSFORMER_KEYS = ("information_transformer_layes.", "spatial_ch_projs.")


def flax_module_of(unet_key: str) -> str:
    """The JAX UNet's top-level module that holds the port's UNet state-dict
    entry `unet_key` (the inverse of `utils.convert.state_dict_from_flax`'s
    fusion renames)."""
    if unet_key.startswith(_INFO_TRANSFORMER_KEYS):
        return "information_transformer"
    return unet_key.split(".", 1)[0]


def param_labels(unet: nn.Module, denoise_encoder: nn.Module,
                 stage: int) -> Dict[str, str]:
    """Label of each parameter, by its qualified name ("unet.<key>" or
    "denoise_encoder.<key>"): stage 1 trains the adapters ("train") and
    freezes the rest ("freeze"); stage 2 trains the UNet ("train") and the
    denoise encoder ("vis")."""
    labels = {}
    for name, _ in unet.named_parameters():
        adapter = flax_module_of(name) in _ADAPTER_KEYS
        labels["unet." + name] = ("train" if stage == 2 or adapter
                                  else "freeze")
    for name, _ in denoise_encoder.named_parameters():
        labels["denoise_encoder." + name] = "vis" if stage == 2 else "freeze"
    return labels


def named_params(unet: nn.Module, denoise_encoder: nn.Module
                 ) -> Dict[str, nn.Parameter]:
    out = {"unet." + k: p for k, p in unet.named_parameters()}
    out.update({"denoise_encoder." + k: p
                for k, p in denoise_encoder.named_parameters()})
    return out


def global_norm(grads) -> torch.Tensor:
    """optax's `global_norm`: the L2 norm over every tensor, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm_(grads, g_norm: torch.Tensor, max_norm: float) -> None:
    """optax's `clip_by_global_norm`, in place: scale by max_norm / norm
    only when the norm reaches max_norm."""
    if not float(g_norm) < max_norm:
        for g in grads:
            g.div_(g_norm).mul_(max_norm)


@torch.no_grad()
def adamw_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
           nu: torch.Tensor, lr: float, count: int, b1: float, b2: float,
           eps: float, weight_decay: float) -> None:
    """One optax `adamw` update of `p` in place (`count` = this update's
    1-based step): moments in fp32, bias-corrected, decoupled weight
    decay, then `-lr` times the update."""
    mu.mul_(b1).add_(g * (1 - b1))
    nu.mul_(b2).add_(g * g * (1 - b2))
    update = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count))
                                         + eps)
    update.add_(p * weight_decay)
    p.add_(update.mul_(-lr))


class Optimizer:
    """optax's `MultiSteps(chain(clip_by_global_norm, multi_transform(
    {"train": adamw, "vis": adamw})))` over the trainable parameters, in
    place. `mini_step` counts micro-steps since the last update,
    `gradient_step` the updates (the schedules' and Adam's count); the
    accumulated gradient is each parameter's `.grad`. With `shards` (ZeRO
    over a process group) the gradients are averaged over its ranks at
    each update and each rank updates and keeps moments for its rows; the
    state dict holds the whole moments and the ranks' mean gradient, so a
    checkpoint resumes on any number of ranks."""

    def __init__(self, cfg: TrainConfig, params: Dict[str, nn.Parameter],
                 labels: Dict[str, str], shards: Optional[LeadingShards] = None):
        self.cfg = cfg
        self.params = params                       # trainable only
        self.labels = {k: labels[k] for k in params}
        self.shards = shards
        self.schedules = {"train": make_lr_schedule(cfg),
                          "vis": make_vis_schedule(cfg)}
        self.mu = {k: torch.zeros_like(self.local(k, p), dtype=torch.float32)
                   for k, p in params.items()}
        self.nu = {k: torch.zeros_like(self.local(k, p), dtype=torch.float32)
                   for k, p in params.items()}
        self.mini_step = 0
        self.gradient_step = 0

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of `t` (all of it without shards)."""
        return t if self.shards is None else self.shards.local(name, t)

    def lr(self, label: str, count: Optional[int] = None) -> float:
        return self.schedules[label](self.gradient_step if count is None
                                     else count)

    @contextlib.contextmanager
    def accumulating(self):
        """Hooks for one micro-step's backward: each trainable gradient g
        is added to the squared norm (yielded, a list of device scalars)
        and enters `.grad` as optax's running mean."""
        squares: List[torch.Tensor] = []
        n = self.mini_step

        def hook_for(p):
            def hook(g):
                squares.append(g.float().square().sum())
                if p.grad is None:
                    return g
                return (g - p.grad) / (n + 1)
            return hook

        handles = [p.register_hook(hook_for(p)) for p in self.params.values()]
        try:
            yield squares
        finally:
            for h in handles:
                h.remove()

    @torch.no_grad()
    def step(self) -> bool:
        """After a micro-step's backward: apply the update at the k-th
        micro-step (then `.grad` is cleared), else keep accumulating.
        Returns whether parameters changed."""
        k = self.cfg.grad_accum
        emit = self.mini_step == k - 1
        self.mini_step = (self.mini_step + 1) % k
        if emit:
            self._apply()
            self.gradient_step += 1
        return emit

    def _mean_over_ranks_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.shards.group)
        return t.div_(self.shards.world)

    def _apply(self) -> None:
        cfg = self.cfg
        grads = {}
        for name, p in self.params.items():
            grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
        if self.shards is None:
            g_norm = global_norm(grads.values())
        else:
            for g in grads.values():
                self._mean_over_ranks_(g)
            # each rank's squares over what it owns, summed over the ranks
            sq = sum(self.local(k, g).float().square().sum()
                     for k, g in grads.items() if self.shards.counts(k))
            dist.all_reduce(sq, group=self.shards.group)
            g_norm = torch.sqrt(sq)
        clip_by_global_norm_(grads.values(), g_norm, cfg.max_grad_norm)
        count = self.gradient_step + 1
        lrs = {label: self.lr(label) for label in ("train", "vis")}
        for name, p in self.params.items():
            adamw_(self.local(name, p), self.local(name, grads[name]),
                   self.mu[name], self.nu[name], lrs[self.labels[name]], count,
                   cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                   cfg.adam_weight_decay)
            if self.shards is not None:
                self.shards.gather(name, self.local(name, p), out=p.data)
            p.grad = None

    def state_dict(self) -> dict:
        """The whole state (a collective over the ranks under shards)."""
        acc = {k: p.grad for k, p in self.params.items() if p.grad is not None}
        mu, nu = self.mu, self.nu
        if self.shards is not None:
            mu = {k: self.shards.gather(k, v) for k, v in mu.items()}
            nu = {k: self.shards.gather(k, v) for k, v in nu.items()}
            acc = {k: self._mean_over_ranks_(g.clone()) for k, g in acc.items()}
        return {"mu": mu, "nu": nu, "mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc": acc}

    def load_state_dict(self, sd: dict) -> None:
        for k in self.params:
            self.mu[k].copy_(self.local(k, sd["mu"][k]))
            self.nu[k].copy_(self.local(k, sd["nu"][k]))
            acc = sd["acc"].get(k)
            self.params[k].grad = (None if acc is None else
                                   acc.to(self.params[k].device, copy=True))
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])


@dataclasses.dataclass
class TrainState:
    step: int                          # micro-steps taken
    unet: nn.Module
    denoise_encoder: nn.Module
    opt: Optimizer
    ema: EMAState
    # ZeRO rows of the EMA shadow (stage 2 under data parallelism)
    ema_shards: Optional[LeadingShards] = None

    def trainable(self) -> Dict[str, nn.Parameter]:
        return self.opt.params

    def ema_sources(self) -> Dict[str, torch.Tensor]:
        """What each EMA shadow follows: a trainable tensor, or this rank's
        rows of it when the shadow is sharded."""
        if self.ema_shards is None:
            return self.trainable()
        return {k: self.ema_shards.local(k, p) for k, p in self.trainable().items()}

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole EMA shadow (a collective over the ranks when sharded)."""
        if self.ema_shards is None:
            return self.ema.params
        return {k: self.ema_shards.gather(k, v) for k, v in self.ema.params.items()}


def init_train_state(cfg: TrainConfig, unet: nn.Module,
                     denoise_encoder: nn.Module,
                     data_parallel: bool = False) -> TrainState:
    """Freeze what the stage does not train (`requires_grad_(False)`) and
    start the optimizer and the EMA over the rest; `data_parallel` shards
    them over the default process group as the module docstring says, and
    sets the UNet's `fusion_group` to it."""
    labels = param_labels(unet, denoise_encoder, cfg.stage)
    params = named_params(unet, denoise_encoder)
    for name, p in params.items():
        p.requires_grad_(labels[name] != "freeze")
    trainable = {k: p for k, p in params.items() if labels[k] != "freeze"}
    shards = None
    if data_parallel:
        shards = LeadingShards(trainable)
        # the fusion stack's whole-batch attention spans the global batch
        unet.fusion_group = shards.group or dist.group.WORLD
    state = TrainState(step=0, unet=unet, denoise_encoder=denoise_encoder,
                       opt=Optimizer(cfg, trainable, labels, shards),
                       ema=EMAState({}),
                       ema_shards=shards if cfg.stage == 2 else None)
    state.ema = ema_init(state.ema_sources())
    return state


def draw_noise(batch_size: int, latent_shape, num_train_timesteps: int,
               generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One micro-step's randomness, from `generator` (on the CPU or on
    `device`): the VAE posterior's N(0, 1), the noise, the offset noise
    [B, C, 1, 1] (fp32, on `device`) and the timesteps in
    [0, num_train_timesteps) (int64, on the CPU)."""
    gen_device = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=gen_device).to(device)

    c = latent_shape[1]
    return {
        "posterior": normal(latent_shape),
        "noise": normal(latent_shape),
        "offset": normal((batch_size, c, 1, 1)),
        "t": torch.randint(0, num_train_timesteps, (batch_size,),
                           generator=generator, device=gen_device).cpu(),
    }


def _nchw(x, device) -> torch.Tensor:
    """[B, H, W, C] array -> contiguous fp32 [B, C, H, W] on `device`."""
    t = torch.as_tensor(x, dtype=torch.float32)
    return t.permute(0, 3, 1, 2).contiguous().to(device)


def make_train_step(unet: nn.Module, denoise_encoder: nn.Module, vae: nn.Module,
                    cfg: TrainConfig,
                    scheduler_config: SchedulerConfig = SchedulerConfig(),
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """Returns step(state, batch, generator=None, draws=None, rows=None)
    -> metrics, one micro-step in place on `state`.

    batch (numpy or torch, the JAX package's NHWC layout): hr and lq
    [B, H, W, 3] in [-1, 1], prompt_embeds [B, 77, 2048], pooled_embeds
    [B, 1280], add_time_ids [B, 6]. The randomness comes from `draws`
    (the keys of `draw_noise`, e.g. the JAX step's own draws in a test)
    or is drawn from `generator` for the whole batch. `rows` (a slice: a
    data-parallel rank's share) then keeps those rows of the batch and of
    the draws, so the ranks together see what one process would. Metrics:
    `loss` and `grad_norm`, the norm of this micro-step's gradients
    (device scalars; this rank's)."""
    ddpm = DDPMScheduler(scheduler_config)
    n_train_t = scheduler_config.num_train_timesteps
    scaling = vae.config.scaling_factor
    device = next(unet.parameters()).device
    autocast = compute_dtype != torch.float32

    def amp():
        return torch.autocast(device.type, dtype=compute_dtype,
                              enabled=autocast)

    def loss_fn(batch, draws):
        hr = _nchw(batch["hr"], device)
        lq = _nchw(batch["lq"], device)
        with torch.no_grad(), amp():
            moments = vae.encode_moments(hr)
            latents = sample_from_moments(moments, noise=draws["posterior"])
        latents = latents.float() * scaling
        noise = draws["noise"]
        if cfg.noise_offset > 0:
            noise = noise + cfg.noise_offset * draws["offset"]
        t = draws["t"]
        noisy = ddpm.add_noise(latents, noise, t)
        with amp():
            lq_feats = denoise_encoder(lq)
            eps = unet(noisy, t.float(),
                       torch.as_tensor(batch["prompt_embeds"]).to(device),
                       torch.as_tensor(batch["pooled_embeds"]).to(device),
                       torch.as_tensor(batch["add_time_ids"]).to(device),
                       lq_feats, True, None)
        # L1 on epsilon, fp32 accumulation
        return torch.mean(torch.abs(eps.float() - noise.float()))

    def step(state: TrainState, batch, generator: Optional[torch.Generator]
             = None, draws: Optional[Dict[str, torch.Tensor]] = None,
             rows: Optional[slice] = None) -> dict:
        if draws is None:
            b, h, w = batch["hr"].shape[:3]
            draws = draw_noise(
                b, (b, vae.config.latent_channels, h // 8, w // 8), n_train_t,
                generator, device)
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
            draws = {k: v[rows] for k, v in draws.items()}
        # the micro-step's spans: train_step.forward, .backward and .optimizer
        with state.opt.accumulating() as squares:
            with span("train_step.forward"):
                loss = loss_fn(batch, draws)
            with span("train_step.backward"):
                loss.backward()
        with span("train_step.optimizer"):
            grad_norm = torch.sqrt(torch.stack(squares).sum())
            state.opt.step()
            state.step += 1
            # the EMA gates on optimizer steps (the reference's global_step):
            # `step` counts micro-steps, so the interval scales by grad_accum
            ema_update(state.ema, state.ema_sources(), state.step,
                       interval=cfg.ema_update_interval * cfg.grad_accum,
                       decay=cfg.ema_decay)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
