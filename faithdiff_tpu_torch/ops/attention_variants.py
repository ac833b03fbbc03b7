"""Attention variants for the variant benchmark: softmax in base e or base
2, and the K/V tile depth (`fd_attention_variant_fwd` in
`csrc/flash_attention.cu`, the port of the kernel in
`scripts/bench_attention_variants.py`).

`attention_variant` launches the kernel for a CUDA tensor and computes
`attention_variant_reference` for a CPU tensor. Both take ``[BH, S, 64]``
and are non-causal.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import (GROUP_ROWS, LOG2E, _check_kernel_inputs,
                        _geometry_argument, _launch, bhsd_geometry)

HEAD_DIM = 64
# K/V rows per tile the kernel is instantiated for (128 q rows a block)
BLOCK_K = (64, 128)
# every variant the kernel has: (base2, block_k)
VARIANTS = tuple((base2, bk) for base2 in (False, True) for bk in BLOCK_K)


def attention_variant_reference(q, k, v, scale: float, base2: bool):
    """The variant's arithmetic in full-softmax form, fp32. base2: q times
    scale * log2 e, rounded to q's dtype, then exp2 of the logits; base e:
    the logits times scale, then exp. Unnormalised probs are cast to v's
    dtype before p.v, and the sum divides after, as in the kernel."""
    if base2:
        q32 = (q.float() * (scale * LOG2E)).to(q.dtype).float()
        s = torch.matmul(q32, k.float().transpose(-1, -2))
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def attention_variant(q, k, v, scale: float, base2: bool, block_k: int):
    """One variant over ``[BH, S, 64]``. A CUDA tensor launches the kernel
    (bf16, contiguous, block_k in `BLOCK_K`) and raises on anything it does
    not take; a CPU tensor computes `attention_variant_reference`."""
    if q.device.type == "cpu":
        return attention_variant_reference(q, k, v, scale, base2)
    _check_kernel_inputs("attention_variant", q, (("q", q), ("k", k), ("v", v)))
    if q.dtype != torch.bfloat16:
        raise TypeError(f"attention_variant: q is {q.dtype}, kernel takes bfloat16")
    if block_k not in BLOCK_K:
        raise ValueError(f"attention_variant: block_k {block_k}, kernel takes {BLOCK_K}")
    bh, q_len, d = q.shape
    kv_len = k.shape[1]
    if d != HEAD_DIM or k.shape != (bh, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"attention_variant: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}, head dim 64")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"attention_variant: {name} is not contiguous")
    out = torch.empty_like(q)
    geometry = _geometry_argument((
        bhsd_geometry(q.shape, GROUP_ROWS), bhsd_geometry(k.shape, block_k),
        bhsd_geometry(v.shape, block_k), bhsd_geometry(out.shape, GROUP_ROWS)))
    _launch(_build.load("flash_attention"), "fd_attention_variant_fwd",
            [ctypes.c_void_p] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
             scale * LOG2E if base2 else scale, int(base2), block_k), q.device)
    _build.launches["attention_variant_fwd"] += 1
    return out
