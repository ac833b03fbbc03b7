"""Attention over ``[batch, heads, seq, head_dim]`` tensors, and over the
packed ``[batch, seq, heads * head_dim]`` projection outputs.

Counterpart of `faithdiff_tpu/ops/attention.py`. Long attention at head
dim 64 or 128 goes to the hand-written flash kernels
(`csrc/flash_attention.cu`: the ports of `_flash_kernel` and
`_flash_kernel_bsnd`); everything the JAX package keeps outside Pallas
stays plain torch, as XLA ran it there: the 77-token cross-attention, the
g=2 fusion attention, and the single-head d=512 VAE mid-attention, which
goes through the chunked online softmax.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634

# the kernel pays off once the score matrix is large (the JAX gate)
_MIN_FLASH_SEQ = 1024
# the head dims the kernels are instantiated for: the UNet's (64) and the
# LLaMA / MPT captioners' (128), every d%64==0 head dim of the repo's
# models that reaches attention at >= 1024 tokens
_FLASH_HEAD_DIMS = (64, 128)
# score-matrix size above which the plain path becomes memory-hostile
_MAX_PLAIN_SCORE_ELEMS = 64 * 1024 * 1024


def attention_reference(q, k, v, scale: float, causal: bool = False):
    """Plain attention (`_xla_attention`): fp32 logits, fp32 softmax, probs
    cast to v's dtype before the weighted sum. The causal mask is aligned
    bottom-right, `tril(ones, k_len - q_len)`, as in the JAX reference."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~mask, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, scale: float, chunk: int = 1024):
    """Memory-bounded attention (`_chunked_xla_attention`): a loop over KV
    chunks with a running online softmax, all in fp32. Non-causal."""
    kv_len = k.shape[2]
    while kv_len % chunk:
        chunk //= 2
    q32 = q.float() * scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1] + (1,), DEFAULT_MASK_VALUE,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for s in range(0, kv_len, chunk):
        kb = k[:, :, s:s + chunk].float()
        vb = v[:, :, s:s + chunk].float()
        logits = torch.matmul(q32, kb.transpose(-1, -2))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    return (acc / l).to(q.dtype)


def _check_kernel_inputs(what: str, q, tensors) -> None:
    """Raise on what the flash kernels do not take: another device, another
    dtype than bf16, or data that does not start on 16 bytes (rows move as
    16-byte vectors)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} is {t.dtype}, kernel takes bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _launch(lib, fn_name: str, argtypes, args, device) -> None:
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    _build.check(lib, code, fn_name)


def flash_attention(q, k, v, scale: float, causal: bool = False):
    """Flash-attention forward. A CUDA tensor launches the kernel (bf16,
    head dim 64 or 128, contiguous ``[B, H, S, d]``) and raises on anything
    the kernel does not take; a CPU tensor computes `attention_reference`."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, causal)
    _check_kernel_inputs("flash_attention", q, (("q", q), ("k", k), ("v", v)))
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}, kernel takes "
                         f"{_FLASH_HEAD_DIMS}")
    if k.shape != (b, h, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if causal and q_len != kv_len:
        # the TPU kernel masks top-left (q_idx >= k_idx) while its reference
        # masks bottom-right; they agree only for square score matrices
        raise ValueError("flash_attention: causal needs q_len == kv_len")
    if b * h > 65535:
        raise ValueError(f"flash_attention: batch*heads {b * h} > 65535")
    out = torch.empty_like(q)
    _launch(_build.load("flash_attention"), "fd_flash_attention_fwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b * h, q_len, kv_len, d, scale * LOG2E, int(causal)), q.device)
    _build.launches["flash_attention_fwd"] += 1
    return out


def _flash_gate(q_len: int, kv_len: int, head_dim: int) -> bool:
    """Long sequences on both sides at a head dim the kernels take. JAX's
    gate (`multi_head_attention`, `attention_packed`) also asks for lengths
    that are a multiple of 128 and, in the BHSD kernel, for K/V that fit
    the TPU's VMEM; the card's kernels mask partial tiles and stream K/V,
    so the port keeps neither condition and serves a superset."""
    return (q_len >= _MIN_FLASH_SEQ and kv_len >= _MIN_FLASH_SEQ
            and head_dim in _FLASH_HEAD_DIMS)


def flash_eligible(q, k) -> bool:
    """The ``[B, H, S, d]`` shapes the flash kernel serves: every UNet
    self-attention (d=64) and the LLaMA causal prefill at >= 1024 tokens
    (d=128)."""
    return _flash_gate(q.shape[2], k.shape[2], q.shape[-1])


def multi_head_attention(q, k, v, *, scale: Optional[float] = None,
                         causal: bool = False):
    """Scaled dot-product attention over ``[B, H, S, D]`` tensors.

    Long attention at d=64 or 128 goes to `flash_attention` (the kernel on
    CUDA); long non-causal score matrices to `chunked_attention`; the rest
    to `attention_reference`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_eligible(q, k):
        return flash_attention(q, k, v, scale, causal)
    score_elems = q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]
    if not causal and score_elems > _MAX_PLAIN_SCORE_ELEMS:
        return chunked_attention(q, k, v, scale)
    return attention_reference(q, k, v, scale, causal)


def einsum_bsnd(q, k, v, heads: int, scale: float):
    """Plain packed-layout attention (`_einsum_bsnd`): q ``[b, sq, n*d]``,
    k/v ``[b, skv, n*d]``; fp32 logits and softmax, probs cast to v's dtype
    before the weighted sum. Returns ``[b, sq, n*d]`` in q's dtype."""
    b, sq, f = q.shape
    skv = k.shape[1]
    d = f // heads
    q4 = q.reshape(b, sq, heads, d)
    k4 = k.reshape(b, skv, heads, d)
    v4 = v.reshape(b, skv, heads, d)
    s = torch.einsum("bqnd,bknd->bnqk", q4.float(), k4.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).float(), v4.float())
    return out.to(q.dtype).reshape(b, sq, f)


def _packed_strides(name: str, t, f: int):
    """(batch stride, row stride) of a packed ``[b, s, f]`` operand, in
    elements. The kernel reads each head's d columns of a row as 16-byte
    vectors, so it needs unit column stride and batch / row strides that
    are multiples of 8 bf16; a row stride >= f lets q/k/v be column slices
    of one fused projection."""
    sb, sr, sc = t.stride()
    if sc != 1 or sr < f or sr % 8 or sb % 8:
        raise ValueError(f"flash_attention_packed: {name} strides {t.stride()} "
                         f"are not packed rows of {f} elements")
    return sb, sr


def flash_attention_packed(q, k, v, heads: int, scale: float):
    """Packed-layout flash attention, non-causal: q ``[b, sq, n*d]``, k/v
    ``[b, skv, n*d]`` -> ``[b, sq, n*d]``. A CUDA tensor launches the kernel
    (bf16, d = 64 or 128, packed rows as `_packed_strides` describes) and
    raises on anything it does not take; a CPU tensor computes
    `einsum_bsnd`."""
    if q.device.type == "cpu":
        return einsum_bsnd(q, k, v, heads, scale)
    _check_kernel_inputs("flash_attention_packed", q,
                         (("q", q), ("k", k), ("v", v)))
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention_packed: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, f = q.shape
    skv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != f or f % heads:
        raise ValueError(f"flash_attention_packed: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, {heads} heads")
    d = f // heads
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_packed: head dim {d}, kernel takes "
                         f"{_FLASH_HEAD_DIMS}")
    if b * heads > 65535:
        raise ValueError(f"flash_attention_packed: batch*heads {b * heads} > 65535")
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _packed_strides(name, t, f)]
    out = torch.empty((b, sq, f), dtype=q.dtype, device=q.device)
    _launch(_build.load("flash_attention"), "fd_flash_attention_bsnd_fwd",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_void_p],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, heads, d, sq, skv, *strides, scale * LOG2E), q.device)
    _build.launches["flash_attention_bsnd_fwd"] += 1
    return out


def attention_packed(q, k, v, heads: int, scale: Optional[float] = None):
    """Attention over packed ``[b, s, n*d]`` activations (the projections'
    natural layout), with no head transposes on either side. Long
    attention on both sides at d = 64 or 128 (every UNet self-attention)
    goes to `flash_attention_packed`; the rest (the 77-token
    cross-attention) to `einsum_bsnd`."""
    d = q.shape[2] // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _flash_gate(q.shape[1], k.shape[1], d):
        return flash_attention_packed(q, k, v, heads, scale)
    return einsum_bsnd(q, k, v, heads, scale)
