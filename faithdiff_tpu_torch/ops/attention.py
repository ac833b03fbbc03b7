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
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from .autograd import wide, with_plain_backward

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
# the flash kernels' tiles (`csrc/flash_tile.cuh`, `csrc/flash_attention.cu`):
# a block owns BLOCK_Q q rows, GROUP_ROWS a consumer warpgroup, and walks
# K/V in tiles of BLOCK_K rows; TMA moves 64-column (128-byte) panels
BLOCK_Q = 128
GROUP_ROWS = 64
BLOCK_K = 128
PANEL_COLS = 64


def _without_autocast(fn):
    """Run a plain attention in its inputs' dtypes with fp32 math, also
    inside an autocast region (which would round its logits to bf16). The
    Functions' backward turns autocast off itself; this is for the forward
    calls a training step makes outside them (attention below 1024 tokens,
    cross-attention, the fusion adapters)."""
    @functools.wraps(fn)
    def run(q, *args, **kwargs):
        if torch.is_autocast_enabled(q.device.type):
            with torch.autocast(q.device.type, enabled=False):
                return fn(q, *args, **kwargs)
        return fn(q, *args, **kwargs)
    return run


@_without_autocast
def attention_reference(q, k, v, scale: float, causal: bool = False):
    """Plain attention (`_xla_attention`): fp32 logits, fp32 softmax, probs
    cast to v's dtype before the weighted sum. The causal mask is aligned
    bottom-right, `tril(ones, k_len - q_len)`, as in the JAX reference."""
    logits = torch.matmul(wide(q), wide(k).transpose(-1, -2)) * scale
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~mask, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(wide(probs.to(v.dtype)), wide(v))
    return out.to(q.dtype)


@_without_autocast
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
    dtype than bf16, or data that does not start on 16 bytes (a TMA tensor
    map's base address must)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} is {t.dtype}, kernel takes bfloat16")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


class TmaGeometry(NamedTuple):
    """One operand as its 4-D TMA tensor map sees it: `dims` = (columns of
    a head, heads, rows, batches), innermost first; `strides` = the byte
    strides of heads, rows and batches; `box` = the tile one load or store
    moves, in elements of each dim."""
    dims: tuple
    strides: tuple
    box: tuple


def _tma_geometry(d, heads, rows, batches, head_stride, row_stride,
                  batch_stride, box_rows) -> TmaGeometry:
    """Strides in bf16 elements. A dimension of extent 1 is given the
    stride of a contiguous tensor (its own never enters an address); every
    other one must be a positive multiple of 16 bytes, as TMA demands."""
    if d % PANEL_COLS:
        raise ValueError(f"head dim {d} is not a multiple of {PANEL_COLS}")
    strides = []
    for extent, stride, dense in ((heads, head_stride, d),
                                  (rows, row_stride, heads * d),
                                  (batches, batch_stride, rows * heads * d)):
        if extent == 1:
            stride = dense
        if stride <= 0 or stride % 8 or 2 * stride >= 1 << 40:
            raise ValueError(f"stride {stride} of an extent of {extent} is not a "
                             "positive multiple of 8 elements below 2^39")
        strides.append(2 * stride)
    dims = (d, heads, rows, batches)
    if min(dims) < 1 or max(dims) > 1 << 32 or not 1 <= box_rows <= 256:
        raise ValueError(f"dims {dims}, box rows {box_rows}")
    return TmaGeometry(dims, tuple(strides), (PANEL_COLS, 1, box_rows, 1))


@functools.lru_cache(maxsize=256)
def bhsd_geometry(shape, box_rows: int) -> TmaGeometry:
    """A contiguous ``[B, H, S, d]`` (or ``[BH, S, d]``) tensor: B*H planes
    of S rows, no head dimension inside a plane."""
    *planes, rows, d = shape
    return _tma_geometry(d, 1, rows, math.prod(planes), d, d, rows * d, box_rows)


@functools.lru_cache(maxsize=256)
def packed_geometry(shape, stride, heads: int, box_rows: int) -> TmaGeometry:
    """A packed ``[b, s, n*d]`` tensor with element strides `stride` (unit
    column stride): head h of row r starts h*d elements into the row."""
    b, rows, f = shape
    batch_stride, row_stride, col_stride = stride
    if col_stride != 1 or f % heads:
        raise ValueError(f"packed rows of {f} columns, {heads} heads, column "
                         f"stride {col_stride}")
    d = f // heads
    return _tma_geometry(d, heads, rows, b, d, row_stride, batch_stride, box_rows)


@functools.lru_cache(maxsize=256)
def _geometry_argument(geometries: tuple):
    """q, k, v, o geometries as the C entry points read them: per operand
    4 dims, 3 byte strides and 4 box extents, all uint64. The UNet asks
    for the same few shapes 70 times a call, so the array is kept (the
    entry points only read it)."""
    flat = [x for g in geometries for part in g for x in part]
    return (ctypes.c_uint64 * len(flat))(*flat)


def _launch(lib, fn_name: str, argtypes, args, device) -> None:
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    _build.check(lib, code, fn_name)


def flash_attention(q, k, v, scale: float, causal: bool = False):
    """Flash attention. A CUDA tensor launches the kernel (bf16, head dim
    64 or 128, contiguous ``[B, H, S, d]``) and raises on anything the
    kernel does not take; under autograd its gradient is that of
    `attention_reference` (`flash_attention_function`). A CPU tensor
    computes `attention_reference`."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, causal)
    return flash_attention_function(q, k, v, scale, causal)


def flash_attention_function(q, k, v, scale: float, causal: bool = False, *,
                             forward=None):
    """`forward` (default: the kernel launch) with the backward of
    `attention_reference`, as JAX's `custom_vjp` of `_flash_attention`.
    Tests pass `forward=attention_reference` to run the wiring without a
    card."""
    return with_plain_backward(forward or _flash_attention_launch,
                               attention_reference, q, k, v, scale=scale,
                               causal=causal)


def _flash_attention_launch(q, k, v, scale: float, causal: bool):
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
    out = torch.empty_like(q)
    geometry = _geometry_argument((
        bhsd_geometry(q.shape, GROUP_ROWS), bhsd_geometry(k.shape, BLOCK_K),
        bhsd_geometry(v.shape, BLOCK_K), bhsd_geometry(out.shape, GROUP_ROWS)))
    _launch(_build.load("flash_attention"), "fd_flash_attention_fwd",
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
             d, scale * LOG2E, int(causal)), q.device)
    _build.launches["flash_attention_fwd"] += 1
    return out


def kv_tiles(q0: int, kv_len: int, causal: bool, block_q: int = BLOCK_Q,
             block_k: int = BLOCK_K) -> int:
    """K/V tiles the kernel's block that starts at q row `q0` visits: all
    of them, or under the causal mask those that hold a column <= the
    block's last row (`kv_tiles` in `csrc/flash_tile.cuh`)."""
    every = -(-kv_len // block_k)
    if not causal:
        return every
    return min(every, (q0 + block_q + block_k - 1) // block_k)


def flash_attention_tiled(q, k, v, scale: float, causal: bool = False, *,
                          base2: bool = True, block_q: int = BLOCK_Q,
                          block_k: int = BLOCK_K, visited=None):
    """The flash kernels' schedule in plain PyTorch, for tests: ``[B, H, S,
    d]`` operands, blocks of `block_q` q rows split into groups of
    `GROUP_ROWS`, each walking the K/V tiles of `block_k` rows that
    `kv_tiles` bounds with the kernel's online softmax. In base 2 q takes
    scale * log2 e and is rounded to its dtype; in base e each fp32 score
    is scaled. p enters the sum in fp32 and p.v in v's dtype; columns past
    kv_len and above the causal diagonal (top-left) score `-0.7 * FLT_MAX`;
    a group skips a tile wholly above its rows. `visited`, a list, gets
    one ``(q0, k0)`` per tile a block walks."""
    q_len, kv_len = q.shape[2], k.shape[2]
    exp = torch.exp2 if base2 else torch.exp
    if base2:
        qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    else:
        qs = q.float()
    out = torch.empty_like(q)
    for q0 in range(0, q_len, block_q):
        n_tiles = kv_tiles(q0, kv_len, causal, block_q, block_k)
        if visited is not None:
            visited += [(q0, t * block_k) for t in range(n_tiles)]
        for g0 in range(q0, min(q0 + block_q, q_len), GROUP_ROWS):
            rows = torch.arange(g0, min(g0 + GROUP_ROWS, q_len), device=q.device)
            qg = qs[:, :, rows]
            acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
            m = torch.full(qg.shape[:-1] + (1,), DEFAULT_MASK_VALUE,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            for t in range(n_tiles):
                k0 = t * block_k
                if causal and k0 > g0 + GROUP_ROWS - 1:
                    continue
                cols = torch.arange(k0, k0 + block_k, device=q.device)
                live = cols < kv_len
                kt = k[:, :, k0:k0 + block_k].float()
                vt = v[:, :, k0:k0 + block_k]
                pad = block_k - kt.shape[2]       # TMA zero-fills a partial tile
                kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
                vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
                s = torch.matmul(qg, kt.transpose(-1, -2))
                if not base2:
                    s = s * scale
                keep = live[None, :]
                if causal:
                    keep = keep & (cols[None, :] <= rows[:, None])
                s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = exp(s - m_new)
                alpha = exp(m - m_new)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
                m = m_new
            out[:, :, rows] = (acc / l).to(q.dtype)
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
                         causal: bool = False, use_flash: Optional[bool] = None):
    """Scaled dot-product attention over ``[B, H, S, D]`` tensors.

    Long attention at d=64 or 128 goes to `flash_attention` (the kernel on
    CUDA); long non-causal score matrices to `chunked_attention`; the rest
    to `attention_reference`. `use_flash` overrides the gate, as JAX's
    argument of that name does (False: never the kernel)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash_eligible(q, k) if use_flash is None else use_flash:
        return flash_attention(q, k, v, scale, causal)
    score_elems = q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]
    if not causal and score_elems > _MAX_PLAIN_SCORE_ELEMS:
        return chunked_attention(q, k, v, scale)
    return attention_reference(q, k, v, scale, causal)


@_without_autocast
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
    s = torch.einsum("bqnd,bknd->bnqk", wide(q4), wide(k4)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", wide(p.to(v.dtype)), wide(v4))
    return out.to(q.dtype).reshape(b, sq, f)


def _check_packed_strides(name: str, t, f: int) -> None:
    """Raise unless `t` is a packed ``[b, s, f]`` operand as the kernel's
    tensor maps can address it: unit column stride, and batch / row strides
    that are multiples of 8 bf16 (16 bytes); a row stride >= f lets q/k/v
    be column slices of one fused projection."""
    sb, sr, sc = t.stride()
    if sc != 1 or sr < f or sr % 8 or sb % 8:
        raise ValueError(f"flash_attention_packed: {name} strides {t.stride()} "
                         f"are not packed rows of {f} elements")


def flash_attention_packed(q, k, v, heads: int, scale: float):
    """Packed-layout flash attention, non-causal: q ``[b, sq, n*d]``, k/v
    ``[b, skv, n*d]`` -> ``[b, sq, n*d]``. A CUDA tensor launches the kernel
    (bf16, d = 64 or 128, packed rows as `_check_packed_strides` describes) and
    raises on anything it does not take; a CPU tensor computes
    `einsum_bsnd`. Under autograd the gradient is that of `einsum_bsnd`
    (`flash_attention_packed_function`)."""
    if q.device.type == "cpu":
        return einsum_bsnd(q, k, v, heads, scale)
    return flash_attention_packed_function(q, k, v, heads, scale)


def flash_attention_packed_function(q, k, v, heads: int, scale: float, *,
                                    forward=None):
    """`forward` (default: the kernel launch) with the backward of
    `einsum_bsnd`, as JAX's `custom_vjp` of `_flash_bsnd`. Tests pass
    `forward=einsum_bsnd`."""
    return with_plain_backward(forward or _flash_packed_launch, einsum_bsnd,
                               q, k, v, heads=heads, scale=scale)


def _flash_packed_launch(q, k, v, heads: int, scale: float):
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_packed_strides(name, t, f)
    out = torch.empty((b, sq, f), dtype=q.dtype, device=q.device)
    geometry = _geometry_argument(tuple(
        packed_geometry(t.shape, t.stride(), heads, rows)
        for t, rows in ((q, GROUP_ROWS), (k, BLOCK_K), (v, BLOCK_K),
                        (out, GROUP_ROWS))))
    _launch(_build.load("flash_attention"), "fd_flash_attention_bsnd_fwd",
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
             d, scale * LOG2E), q.device)
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
