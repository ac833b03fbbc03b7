"""GroupNorm with fp32 statistics, an optional per-(batch, channel) `add`
prologue and an optional SiLU epilogue.

Counterpart of `faithdiff_tpu/ops/groupnorm.py`. A CUDA tensor always goes
through a hand-written kernel of `csrc/group_norm.cu` (the port of
`_stats_kernel` + `_apply_kernel`); a CPU tensor through
`group_norm_reference`. Layout ``[B, C, *spatial]`` (NCHW).

`plan_group_norm` makes every launch decision from the shape alone: the
route (one single-pass launch on thread-block clusters, or the two-pass
pair for groups too large for a cluster or shapes a bulk copy cannot
take), the 1-D grids, the cluster size, the bytes per block and the
chunking. `group_norm_tiled` walks the planned blocks in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from .autograd import wide, with_plain_backward

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# two-pass route: elements per stats block (at least) and per apply block
_CHUNK = 16384
_MAX_CHUNKS = 256
_SEGMENT = 16384
# single-pass route: most bytes of x one block holds in shared memory, the
# largest cluster (above 8 blocks a non-portable size, which Hopper
# allows) and the bulk copies a block issues (the kernel's kMaxPieces). The
# cluster is the smallest that holds the group: on an H100, fewer and
# larger slices ran faster than more and smaller ones
# (scripts/bench_group_norm_plan.py)
FUSED_SLICE_BYTES = 64 * 1024
FUSED_MAX_CLUSTER = 16
FUSED_PIECES = 4
# dynamic shared memory a block may use: 227 KB, less the kernel's static
# reduction buffer and some slack
SMEM_LIMIT = 227 * 1024 - 1024
MAX_GRID = 2 ** 31 - 1          # blocks along a grid's x dimension


def group_stats_reference(x, num_groups: int, add=None):
    """Plain version of pass 1: fp32 per-(batch, group) sums of v and v^2,
    v = x (+ add), each [B, G]."""
    b, c = x.shape[:2]
    x32 = wide(x)
    if add is not None:
        x32 = x32 + wide(add).reshape((b, c) + (1,) * (x.ndim - 2))
    dims = tuple(range(2, x.ndim))
    s1 = x32.sum(dim=dims).reshape(b, num_groups, -1).sum(-1)
    s2 = x32.square().sum(dim=dims).reshape(b, num_groups, -1).sum(-1)
    return s1, s2


def group_apply_reference(x, gs1, gs2, scale, bias, num_groups: int,
                          epsilon: float, act: Optional[str] = None, add=None):
    """Plain version of pass 2: mean = S1/n, var = max(S2/n - mean^2, 0),
    y = (x + add) * es + eb, optional SiLU, cast to x's dtype."""
    b, c = x.shape[:2]
    cpg = c // num_groups
    bshape = (b, c) + (1,) * (x.ndim - 2)
    n = x[0, 0].numel() * cpg
    mean = gs1 / n
    var = torch.clamp(gs2 / n - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + epsilon)
    es = rstd.repeat_interleave(cpg, dim=-1) * wide(scale)[None]
    eb = wide(bias)[None] - mean.repeat_interleave(cpg, dim=-1) * es
    x32 = wide(x)
    if add is not None:
        x32 = x32 + wide(add).reshape(bshape)
    y = x32 * es.reshape(bshape) + eb.reshape(bshape)
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_reference(x, scale, bias, num_groups: int, epsilon: float,
                         act: Optional[str] = None, add=None):
    """Plain GroupNorm (the JAX `group_norm_reference`): both passes."""
    gs1, gs2 = group_stats_reference(x, num_groups, add)
    return group_apply_reference(x, gs1, gs2, scale, bias, num_groups,
                                 epsilon, act, add)


class GroupNormPlan(NamedTuple):
    """How one GroupNorm launches. `route` is what `group_norm` runs; the
    two-pass geometry is planned for every shape, the single-pass one
    (`cluster` > 0) where the group fits a cluster. All grids are 1-D."""
    route: str            # "fused" or "two_pass"
    cluster: int          # fused: blocks per (b, g); 0 where it does not fit
    slice_len: int        # fused: elements of x per block
    piece_len: int        # fused: elements per bulk copy
    smem_bytes: int       # fused: dynamic shared memory per block
    fused_grid: int       # fused: B * G * cluster blocks
    vec: bool             # two-pass: 16-byte vector loads and stores
    chunk: int            # two-pass: elements of a group per stats block
    n_chunks: int
    stats_grid: int       # B * G * n_chunks blocks
    segment: int          # two-pass: elements of a channel per apply block
    n_segments: int
    apply_grid: int       # B * C * n_segments blocks

    @property
    def counters(self) -> tuple:
        """The `_build.launches` names one call adds one to."""
        if self.route == "fused":
            return ("group_norm_fused",)
        return ("group_norm_stats", "group_norm_apply")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fused_smem_bytes(slice_len: int, itemsize: int, cpg: int) -> int:
    """Dynamic shared memory of one single-pass block, in the kernel's
    order: the slice, FUSED_PIECES mbarriers, (S1, S2) and (mean, rstd),
    then add, scale and bias for the group's `cpg` channels."""
    return slice_len * itemsize + 8 * FUSED_PIECES + 4 * 4 + 3 * 4 * cpg


def plan_group_norm(shape, itemsize: int, num_groups: int,
                    aligned: bool = True) -> GroupNormPlan:
    """The launch plan of a GroupNorm over a contiguous x of `shape`
    ([B, C, *spatial]) with `itemsize`-byte elements; `aligned` says
    whether x's data starts on 16 bytes. The single-pass route is taken
    when its bulk copies can move the group (x aligned, each channel a
    whole number of 16-byte vectors) and the group fits a cluster of at
    most FUSED_MAX_CLUSTER blocks of FUSED_SLICE_BYTES each. Plans are
    cached by shape and by the planner's constants."""
    return _plan(tuple(map(int, shape)), itemsize, num_groups, aligned,
                 FUSED_SLICE_BYTES, FUSED_MAX_CLUSTER)


@functools.lru_cache(maxsize=1024)
def _plan(shape, itemsize, num_groups, aligned, slice_bytes,
          max_cluster) -> GroupNormPlan:
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    g = num_groups
    cpg = c // g
    length = cpg * hw
    vec = 16 // itemsize
    use_vec = aligned and hw % vec == 0

    # single pass: the smallest power-of-two cluster whose slices fit
    cluster = slice_len = piece_len = smem = 0
    if use_vec:
        n = 1
        while n < max_cluster and _cdiv(length, n) * itemsize > slice_bytes:
            n *= 2
        sl = _cdiv(_cdiv(length, n), vec) * vec
        need = fused_smem_bytes(sl, itemsize, cpg)
        if (sl * itemsize <= slice_bytes and need <= SMEM_LIMIT
                and b * g * n <= MAX_GRID):
            cluster, slice_len, smem = n, sl, need
            piece_len = _cdiv(_cdiv(sl, FUSED_PIECES), vec) * vec

    # two passes: chunks of at least _CHUNK elements, at most _MAX_CHUNKS
    # a group; segments of _SEGMENT elements a channel
    chunk = _cdiv(max(_CHUNK, _cdiv(length, _MAX_CHUNKS)), vec) * vec
    n_chunks = _cdiv(length, chunk)
    n_segments = _cdiv(hw, _SEGMENT)
    stats_grid, apply_grid = b * g * n_chunks, b * c * n_segments
    if max(stats_grid, apply_grid) > MAX_GRID:
        raise ValueError(f"group_norm: {tuple(shape)} needs more than "
                         f"{MAX_GRID} blocks")
    return GroupNormPlan(
        route="fused" if cluster else "two_pass", cluster=cluster,
        slice_len=slice_len, piece_len=piece_len, smem_bytes=smem,
        fused_grid=b * g * cluster, vec=use_vec, chunk=chunk,
        n_chunks=n_chunks, stats_grid=stats_grid, segment=_SEGMENT,
        n_segments=n_segments, apply_grid=apply_grid)


def _warp_fold(partials):
    """The apply kernel's fold of a group's chunk partials [..., n]: lane
    l of one warp sums chunks l, l + 32, ... in order, then the 32 lane sums
    meet in a butterfly of xor shuffles (lane 0's value)."""
    lanes = partials.new_zeros(partials.shape[:-1] + (32,))
    for i in range(partials.shape[-1]):
        lanes[..., i % 32] += partials[..., i]
    idx = torch.arange(32, device=partials.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def group_norm_tiled(x, scale, bias, num_groups: int, epsilon: float,
                     act: Optional[str] = None, add=None, *,
                     route: Optional[str] = None):
    """The kernels' schedule in plain PyTorch (fp32 sums): the planned
    blocks of `route` (default: the plan's), one (S1, S2) pair per block;
    the single-pass route folds a group's pairs in rank order, the
    two-pass route as its apply kernel folds its chunks; then the same
    normalisation as `group_apply_reference`. A test and chip_smoke.py
    hold it against the kernels and the plain versions."""
    plan = plan_group_norm(tuple(x.shape), x.element_size(), num_groups)
    route = route or plan.route
    b, c = x.shape[:2]
    g = num_groups
    cpg, hw = c // g, x[0, 0].numel()
    length = cpg * hw
    v = x.float().reshape(b, c, hw)
    if add is not None:
        v = v + add.float().reshape(b, c, 1)
    flat = v.reshape(b * g, length)
    if route == "fused":
        if not plan.cluster:
            raise ValueError(f"group_norm: {tuple(x.shape)} has no "
                             "single-pass plan")
        per, size = plan.cluster, plan.slice_len
    elif route == "two_pass":
        per, size = plan.n_chunks, plan.chunk
    else:
        raise ValueError(f"group_norm: unknown route {route!r}")
    blocks = F.pad(flat, (0, per * size - length)).reshape(b * g, per, size)
    p1, p2 = blocks.sum(-1), blocks.square().sum(-1)
    if route == "fused":
        s1, s2 = p1.new_zeros(b * g), p2.new_zeros(b * g)
        for r in range(per):                      # rank order
            s1, s2 = s1 + p1[:, r], s2 + p2[:, r]
    else:
        s1, s2 = _warp_fold(p1), _warp_fold(p2)
    mean = (s1 / length).reshape(b, g, 1)
    var = torch.clamp((s2 / length).reshape(b, g, 1) - mean.square(), min=0.0)
    es = torch.rsqrt(var + epsilon) * scale.float().reshape(1, g, cpg)
    eb = bias.float().reshape(1, g, cpg) - mean * es
    y = v * es.reshape(b, c, 1) + eb.reshape(b, c, 1)
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype).reshape(x.shape)


def _param(name, t, shape, device):
    """A parameter as the kernel reads it: in its own type where the kernel
    widens that type, else fp32."""
    if t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"group_norm: {name} {tuple(t.shape)} on {t.device}, "
                         f"expected {shape} on {device}")
    if t.dtype not in _DTYPE_CODES:
        t = t.float()
    return t.contiguous()


class GroupNormLaunch:
    """One GroupNorm on a CUDA tensor: checks the arguments, takes the plan
    of `plan_group_norm`, allocates the output and launches on the current
    stream. `run` takes the plan's route; `fused` and `two_pass` (`stats`,
    then `apply`) launch one route each."""

    def __init__(self, x, scale, bias, num_groups, epsilon, act=None,
                 add=None):
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"group_norm: kernel takes {list(_DTYPE_CODES)}, "
                            f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("group_norm: x is not contiguous")
        if x.ndim < 3:
            raise ValueError(f"group_norm: x must be [B, C, *spatial], "
                             f"got {tuple(x.shape)}")
        if act not in (None, "silu"):
            raise ValueError(f"group_norm: unsupported act {act!r}")
        b, c = x.shape[:2]
        if c % num_groups:
            raise ValueError(f"group_norm: {c} channels not divisible by "
                             f"{num_groups} groups")
        self.plan = plan_group_norm(tuple(x.shape), x.element_size(),
                                    num_groups, x.data_ptr() % 16 == 0)
        self.x, self.b, self.c, self.g = x, b, c, num_groups
        self.hw = math.prod(x.shape[2:])
        self.epsilon, self.silu = float(epsilon), int(act == "silu")
        self.scale = _param("scale", scale, (c,), x.device)
        self.bias = _param("bias", bias, (c,), x.device)
        self.add = None if add is None else _param("add", add, (b, c), x.device)
        self.partial = None
        self.out = torch.empty_like(x)
        self.lib = _declare(_build.load("group_norm"))

    def _stream(self):
        return torch.cuda.current_stream(self.x.device).cuda_stream

    def _add_args(self):
        if self.add is None:
            return None, 0
        return self.add.data_ptr(), _DTYPE_CODES[self.add.dtype]

    def run(self):
        """The plan's route; returns `self.out`."""
        return self.fused() if self.plan.route == "fused" else self.two_pass()

    def fused(self):
        """One single-pass launch on thread-block clusters into `self.out`."""
        p = self.plan
        if not p.cluster:
            raise ValueError(f"group_norm: {tuple(self.x.shape)} has no "
                             "single-pass plan")
        with torch.cuda.device(self.x.device):
            code = self.lib.fd_group_norm_fused(
                _DTYPE_CODES[self.x.dtype], self.x.data_ptr(), *self._add_args(),
                self.scale.data_ptr(), _DTYPE_CODES[self.scale.dtype],
                self.bias.data_ptr(), _DTYPE_CODES[self.bias.dtype],
                self.out.data_ptr(), self.b, self.c, self.hw, self.g,
                p.fused_grid, p.cluster, p.slice_len, p.piece_len,
                p.smem_bytes, self.epsilon, self.silu, self._stream())
        _build.check(self.lib, code, "group_norm_fused")
        _build.launches["group_norm_fused"] += 1
        return self.out

    def two_pass(self):
        """Both passes into `self.out`."""
        self.stats()
        return self.apply()

    def stats(self):
        """Pass 1: per-chunk (S1, S2) partials into `self.partial`."""
        p = self.plan
        if self.partial is None:
            self.partial = torch.empty((self.b * self.g, p.n_chunks, 2),
                                       dtype=torch.float32,
                                       device=self.x.device)
        with torch.cuda.device(self.x.device):
            code = self.lib.fd_group_norm_stats(
                _DTYPE_CODES[self.x.dtype], self.x.data_ptr(), *self._add_args(),
                self.partial.data_ptr(), self.c, self.hw, self.g,
                p.stats_grid, p.chunk, p.n_chunks, int(p.vec), self._stream())
        _build.check(self.lib, code, "group_norm_stats")
        _build.launches["group_norm_stats"] += 1
        return self.partial

    def apply(self):
        """Pass 2: fold the partials and normalise into `self.out`."""
        p = self.plan
        if self.partial is None:
            raise RuntimeError("group_norm: apply() before stats()")
        with torch.cuda.device(self.x.device):
            code = self.lib.fd_group_norm_apply(
                _DTYPE_CODES[self.x.dtype], self.x.data_ptr(), *self._add_args(),
                self.partial.data_ptr(), self.scale.data_ptr(),
                _DTYPE_CODES[self.scale.dtype], self.bias.data_ptr(),
                _DTYPE_CODES[self.bias.dtype], self.out.data_ptr(), self.c,
                self.hw, self.g, p.n_chunks, p.apply_grid, p.segment,
                p.n_segments, self.epsilon, self.silu, int(p.vec),
                self._stream())
        _build.check(self.lib, code, "group_norm_apply")
        _build.launches["group_norm_apply"] += 1
        return self.out


def _declare(lib):
    """Sets the C entry points' argument types, once per loaded library."""
    if getattr(lib, "_gn_declared", False):
        return lib
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.fd_group_norm_fused.argtypes = [i32, ptr, ptr, i32, ptr, i32, ptr, i32,
                                        ptr, i64, i64, i64, i32, i64, i32, i64,
                                        i64, i32, f32, i32, ptr]
    lib.fd_group_norm_fused.restype = i32
    lib.fd_group_norm_stats.argtypes = [i32, ptr, ptr, i32, ptr, i64, i64, i32,
                                        i64, i64, i32, i32, ptr]
    lib.fd_group_norm_stats.restype = i32
    lib.fd_group_norm_apply.argtypes = [i32, ptr, ptr, i32, ptr, ptr, i32, ptr,
                                        i32, ptr, i64, i64, i32, i32, i64, i64,
                                        i32, f32, i32, i32, ptr]
    lib.fd_group_norm_apply.restype = i32
    lib._gn_declared = True
    return lib


def group_norm(x, scale, bias, num_groups: int = 32, epsilon: float = 1e-5,
               act: Optional[str] = None, add=None):
    """GroupNorm over ``[B, C, *spatial]``. `add` ([B, C]) is folded in
    before the statistics (the ResNet time-embedding injection); `act`
    "silu" is applied after the affine. CUDA tensors run the kernels of
    the plan's route, CPU tensors the plain version. Under autograd the
    kernels' gradient is that of `group_norm_reference`
    (`group_norm_function`)."""
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, num_groups, epsilon, act,
                                    add)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    return group_norm_function(x, scale, bias, num_groups, epsilon, act, add)


def group_norm_plain(x, scale, bias, add, *, num_groups, epsilon, act):
    """`group_norm_reference` with the tensors first, as
    `group_norm_function` calls its forward."""
    return group_norm_reference(x, scale, bias, num_groups, epsilon, act, add)


def _group_norm_launch(x, scale, bias, add, *, num_groups, epsilon, act):
    return GroupNormLaunch(x, scale, bias, num_groups, epsilon, act, add).run()


def group_norm_function(x, scale, bias, num_groups: int = 32,
                        epsilon: float = 1e-5, act: Optional[str] = None,
                        add=None, *, forward=None):
    """`forward` (default: the kernels of the plan's route) with the
    backward of `group_norm_reference` for x, scale, bias and add, as JAX's
    `custom_vjp` of `fused_group_norm`. Tests pass
    `forward=group_norm_plain`."""
    return with_plain_backward(forward or _group_norm_launch,
                               group_norm_plain, x, scale, bias, add,
                               num_groups=num_groups, epsilon=epsilon, act=act)
