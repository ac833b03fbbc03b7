"""LayerNorm over the last dim with fp32 statistics (E[x^2] - E[x]^2),
returning x's dtype.

Counterpart of `faithdiff_tpu/models/layers.LayerNorm`, which JAX runs as
one XLA fusion. A CUDA tensor goes through the hand-written kernel of
`csrc/layer_norm.cu`, one launch that reads x once and writes y once; a CPU
tensor through `layer_norm_reference`, the plain chain.

`plan_layer_norm` makes every launch decision from the shape and strides
alone: whether x has to be made contiguous first, the threads a row, the
vectors a thread, 16-byte or element loads, the rows a block and the
grid. `layer_norm_tiled` walks the kernel's threads and its order of sums
in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..utils import profiling
from . import _build
from .autograd import with_plain_backward

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256          # threads a block (the kernel's kThreads)
MAX_ITEMS = 8          # vectors a thread holds (the kernel's kMaxItems)
MAX_GRID = 2 ** 31 - 1  # blocks along a grid's x dimension


def layer_norm_reference(x, weight, bias, epsilon):
    """Plain LayerNorm (the JAX package's formula): single-pass fp32
    statistics, mean = E[x], var = max(E[x^2] - mean^2, 0), the affine in
    fp32, cast to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    m2 = x32.square().mean(dim=-1, keepdim=True)
    var = torch.clamp(m2 - mean.square(), min=0.0)
    x32 = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (x32 * weight.float() + bias.float()).to(x.dtype)


class LayerNormPlan(NamedTuple):
    """How one LayerNorm launches: x as `rows` rows of `d` elements,
    `row_stride` elements apart, unit column stride."""
    copy: bool             # x's rows are not so laid out: made contiguous first
    rows: int
    d: int
    row_stride: int        # of x as launched (d after a copy)
    vec: int               # elements a 16-byte vector
    vector: bool           # 16-byte loads and stores, else element loads
    threads_per_row: int   # a power of two, 1 to THREADS
    items: int             # vectors a thread holds, 1 to MAX_ITEMS
    rows_per_block: int
    grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_stride(shape, stride) -> Optional[int]:
    """Elements between consecutive rows of x seen as [rows, shape[-1]],
    or None where its last dim is not unit-stride or its rows are not one
    stride apart (size-1 dims do not count)."""
    if shape[-1] != 1 and stride[-1] != 1:
        return None
    step, inner = None, 1          # inner: rows inside the dims walked
    for size, st in zip(reversed(shape[:-1]), reversed(stride[:-1])):
        if size == 1:
            continue
        if step is None:
            step = st
        elif st != inner * step:
            return None
        inner *= size
    return shape[-1] if step is None else step


def plan_layer_norm(shape, stride, itemsize: int,
                    aligned: bool = True) -> LayerNormPlan:
    """The launch plan of a LayerNorm over the last dim of an x of `shape`
    and element `stride` with `itemsize`-byte elements; `aligned` says
    whether x's data starts on 16 bytes. A row is held by the fewest
    threads (a power of two) of which none holds more than MAX_ITEMS
    vectors of 16 bytes; 16-byte loads where d, the row stride and x's
    start allow. Raises on a d whose row would need more than a block.
    Plans are cached by shape and strides."""
    return _plan(tuple(shape), tuple(stride), itemsize, aligned)


@functools.lru_cache(maxsize=1024)
def _plan(shape, stride, itemsize, aligned) -> LayerNormPlan:
    if itemsize not in (2, 4):
        raise ValueError(f"layer_norm: {itemsize}-byte elements; the kernel "
                         "takes 2 (bf16, fp16) and 4 (fp32)")
    if not shape or shape[-1] < 1:
        raise ValueError(f"layer_norm: no last dim to normalise in {shape}")
    d, rows = shape[-1], math.prod(shape[:-1])
    step = _row_stride(shape, stride)
    copy = step is None
    if copy:
        step, aligned = d, True        # a fresh contiguous copy
    vec = 16 // itemsize
    vector = aligned and d % vec == 0 and step % vec == 0
    n_vec = _cdiv(d, vec)
    tpr = 1
    while _cdiv(n_vec, tpr) > MAX_ITEMS:
        tpr *= 2
    if tpr > THREADS:
        raise ValueError(f"layer_norm: d = {d} is more than the "
                         f"{THREADS * MAX_ITEMS * vec} elements a block holds")
    rows_per_block = THREADS // tpr
    grid = _cdiv(rows, rows_per_block)
    if grid > MAX_GRID:
        raise ValueError(f"layer_norm: {shape} needs more than {MAX_GRID} "
                         "blocks")
    return LayerNormPlan(copy=copy, rows=rows, d=d, row_stride=step, vec=vec,
                         vector=vector, threads_per_row=tpr,
                         items=_cdiv(n_vec, tpr),
                         rows_per_block=rows_per_block, grid=grid)


def _fold(lanes):
    """The kernel's fold of a row's per-thread sums [..., tpr]: xor shuffles
    inside each warp (offsets below min(tpr, 32)), then the warps' sums
    added in warp order."""
    tpr = lanes.shape[-1]
    width = min(tpr, 32)
    lanes = lanes.reshape(lanes.shape[:-1] + (tpr // width, width))
    idx = torch.arange(width, device=lanes.device)
    o = width // 2
    while o:
        lanes = lanes + lanes[..., idx ^ o]
        o //= 2
    total = lanes[..., 0, 0]
    for w in range(1, tpr // width):
        total = total + lanes[..., w, 0]
    return total


def layer_norm_tiled(x, weight, bias, epsilon):
    """The kernel's schedule in plain PyTorch (fp32): each row's threads
    under x's plan, thread t summing the elements of its vectors t,
    t + tpr, ... in order, the row's fold of `_fold`, then the same
    normalisation as `layer_norm_reference`. A test holds it against the
    plain version and the kernel."""
    plan = plan_layer_norm(x.shape, x.stride(), x.element_size())
    d, tpr, vec = plan.d, plan.threads_per_row, plan.vec
    v = x.float().reshape(-1, d)
    held = plan.items * tpr * vec
    # [rows, items, tpr, vec]: vector t + k * tpr of each row
    slots = torch.nn.functional.pad(v, (0, held - d)).reshape(
        -1, plan.items, tpr, vec)
    s1 = v.new_zeros(v.shape[0], tpr)
    s2 = v.new_zeros(v.shape[0], tpr)
    for k in range(plan.items):
        for j in range(vec):
            e = slots[:, k, :, j]
            s1, s2 = s1 + e, s2 + e * e
    mean = (_fold(s1) / d)[:, None]
    var = torch.clamp(_fold(s2)[:, None] / d - mean.square(), min=0.0)
    y = (v - mean) * torch.rsqrt(var + epsilon)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype).reshape(x.shape)


def _param(name, t, d, index, vector):
    """A parameter as the kernel reads it: [d] on CUDA device `index`,
    contiguous, in its own type where the kernel widens that type (else
    fp32), on 16 bytes for the vector loads."""
    if t.get_device() != index or t.shape != (d,):
        raise ValueError(f"layer_norm: {name} {tuple(t.shape)} on {t.device}, "
                         f"expected ({d},) on cuda:{index}")
    if t.dtype not in _DTYPE_CODES:
        t = t.float()
    if not t.is_contiguous() or (vector and t.data_ptr() % 16):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _declare(lib):
    """Sets the C entry point's argument types, once per loaded library."""
    if getattr(lib, "_ln_declared", False):
        return lib
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.fd_layer_norm.argtypes = [i32, ptr, i64, ptr, i32, ptr, i32, ptr, i64,
                                  i32, i32, i32, i32, i64, f32, i32, ptr]
    lib.fd_layer_norm.restype = i32
    lib._ln_declared = True
    return lib


def _layer_norm_launch(x, weight, bias, *, epsilon):
    """One launch of the kernel on x's current stream; returns y, a new
    contiguous tensor of x's shape and dtype. x is made contiguous first
    where its rows are not one stride apart (`layer_norm.copies`)."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"layer_norm: kernel takes {list(_DTYPE_CODES)}, "
                        f"got {x.dtype}")
    if x.numel() == 0:
        return x.new_empty(x.shape)
    ptr = x.data_ptr()
    plan = _plan(x.shape, x.stride(), x.element_size(), ptr % 16 == 0)
    if plan.copy:
        x = x.contiguous()
        ptr = x.data_ptr()
        profiling.count("layer_norm.copies")
    index = x.get_device()
    w = _param("weight", weight, plan.d, index, plan.vector)
    b = _param("bias", bias, plan.d, index, plan.vector)
    y = x.new_empty(x.shape)
    lib = _declare(_build.load("layer_norm"))
    status = lib.fd_layer_norm(
        code, ptr, plan.row_stride, w.data_ptr(), _DTYPE_CODES[w.dtype],
        b.data_ptr(), _DTYPE_CODES[b.dtype], y.data_ptr(), plan.rows, plan.d,
        plan.threads_per_row, plan.items, plan.vector, plan.grid, epsilon,
        index, torch._C._cuda_getCurrentRawStream(index))
    _build.check(lib, status, "layer_norm")
    _build.launches["layer_norm"] += 1
    return y


def layer_norm_function(x, weight, bias, epsilon: float = 1e-5, *,
                        forward=None):
    """`forward` (default: the kernel) with the backward of
    `layer_norm_reference` for x, weight and bias: training differentiates
    the plain math. Tests pass `forward=layer_norm_reference`."""
    return with_plain_backward(forward or _layer_norm_launch,
                               layer_norm_reference, x, weight, bias,
                               epsilon=float(epsilon))


def layer_norm(x, weight, bias, epsilon: float = 1e-5):
    """LayerNorm over the last dim of x with fp32 statistics, in x's dtype.
    CUDA tensors run the kernel, CPU tensors the plain version; under
    autograd the kernel's gradient is that of `layer_norm_reference`."""
    if x.is_cuda:
        return layer_norm_function(x, weight, bias, epsilon)
    if x.device.type != "cpu":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    return layer_norm_reference(x, weight, bias, epsilon)
