"""Gradients for the hand-written forward kernels.

The JAX package wraps each Pallas kernel on the training path in
`jax.custom_vjp`: the forward is the kernel, the backward is the autodiff
of the plain math, recomputed from the saved inputs (`_flash_bwd`,
`_flash_bsnd`'s vjp, `_fgn_bwd`). `KernelWithPlainBackward` is the same
rule as a `torch.autograd.Function`; no backward kernel is written.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.profiling import span


class KernelWithPlainBackward(torch.autograd.Function):
    """Forward: `forward(*tensors, **kwargs)` (the kernel launch). Backward:
    autograd of `plain(*tensors, **kwargs)` over the saved inputs, in the
    inputs' own dtypes with autocast off, so the plain version's fp32
    logits and statistics are what is differentiated. Entries of `tensors`
    may be None (an absent optional input). The backward is the span
    `plain_backward:<plain's name>` (`utils.profiling.span`)."""

    @staticmethod
    def forward(ctx, forward: Callable, plain: Callable, kwargs: dict,
                *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*tensors)
        return forward(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        with span(f"plain_backward:{ctx.plain.__name__}"):
            with torch.enable_grad(), torch.autocast(grad.device.type,
                                                     enabled=False):
                out = ctx.plain(*inputs, **ctx.kwargs)
            wrt = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return (None, None, None) + tuple(next(grads) if need else None
                                          for need in needs)


def wide(t):
    """A plain version's working dtype for `t`: fp32, or fp64 for fp64
    operands (a float64 gradcheck of the Functions)."""
    return t if t.dtype == torch.float64 else t.float()


def with_plain_backward(forward: Callable, plain: Callable, *tensors,
                        **kwargs):
    """`forward(*tensors, **kwargs)`, differentiable through `plain` when
    autograd records and an input asks for a gradient; otherwise the bare
    call, so inference launches exactly what it launched before."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return KernelWithPlainBackward.apply(forward, plain, kwargs, *tensors)
    return forward(*tensors, **kwargs)
