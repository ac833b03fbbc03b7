"""Attention over ``[batch, heads, seq, head_dim]`` tensors, and over the
packed ``[batch, seq, heads * head_dim]`` projection outputs.

Counterpart of `faithdiff_tpu/ops/attention.py`. Long attention goes to
the hand-written flash kernels (the ports of `_flash_kernel` and
`_flash_kernel_bsnd`, which JAX runs at either dtype): bf16 at head dim 64
or 128 to `csrc/flash_attention.cu`, bf16 at the wide head dims 192 ... 512
to `csrc/flash_attention_wide.cu`, fp32 at all of them to
`csrc/flash_attention_f32.cu` (3xTF32 products on the tensor cores, held
on the CPU through its plain walk `flash_attention_f32_tiled`). The wide
ones serve the single-head d = 512 VAE mid-attention where JAX's gate
admits it (1024 tokens: a 32 x 32 latent). Everything the JAX package
keeps outside Pallas stays plain torch, as XLA ran it there: the 77-token
cross-attention, the g=2 fusion attention, and the VAE mid-attention at
larger latents, which goes through the chunked online softmax.
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
# the head dims of the wgmma kernels (`csrc/flash_attention.cu`): the
# UNet's (64) and the LLaMA / MPT captioners' (128)
_FLASH_HEAD_DIMS = (64, 128)
# the wide head dims, every d % 64 == 0 up to 512, that JAX's gate also
# admits (`csrc/flash_attention_wide.cu` in bf16): the VAE's d = 512
_WIDE_HEAD_DIMS = tuple(range(192, 513, 64))
# JAX's cap on one plane's K/V for its BHSD kernel (`_MAX_PALLAS_KV_ELEMS`),
# kept at the wide head dims: the 16,384-token d = 512 VAE attention of a
# 1024 px tile stays on `chunked_attention`, as in JAX
_MAX_WIDE_KV_ELEMS = 512 * 1024
# JAX's length condition, kept at the wide head dims: both lengths are
# multiples of this
_WIDE_LEN_MULTIPLE = 128
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


# the dtypes the flash kernels take: bf16 (`csrc/flash_attention.cu`) and
# fp32 (`csrc/flash_attention_f32.cu`, the fp32 trainer's)
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_kernel_inputs(what: str, q, tensors) -> None:
    """Raise on what the flash kernels do not take: another device, a dtype
    other than bf16 or fp32, operands of mixed dtypes, or data that does
    not start on 16 bytes (a TMA tensor map's base address must; the fp32
    kernel's float loads ask no more than the allocator gives)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: q is {q.dtype}, kernels take bfloat16 or "
                        "float32")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _check_head_dim(what: str, d: int) -> None:
    """Raise on a head dim no kernel is instantiated for: one that is no
    multiple of 64, or one above 512 (no model of the repo has one)."""
    if d in _FLASH_HEAD_DIMS or d in _WIDE_HEAD_DIMS:
        return
    if d > _WIDE_HEAD_DIMS[-1] and d % 64 == 0:
        raise ValueError(f"{what}: head dim {d} is above {_WIDE_HEAD_DIMS[-1]}, "
                         "the widest the kernels are built for (ROADMAP §2)")
    raise ValueError(f"{what}: head dim {d}, kernels take "
                     f"{_FLASH_HEAD_DIMS + _WIDE_HEAD_DIMS}")


def _check_strided_rows(what: str, tensors, multiple: int) -> None:
    """Raise unless every batch, head and row stride of the strided
    kernels' operands is a multiple of `multiple` elements: 16 bytes, as
    their tensor maps need (8 bf16, 4 fp32)."""
    for name, strides in tensors:
        if any(st % multiple for st in strides):
            raise ValueError(f"{what}: {name} strides {strides} are not "
                             f"multiples of {multiple} elements (16 bytes)")


def _strided_launch(q, k, v, out, strides, dims, scale: float,
                    causal: bool) -> None:
    """The kernels that take element strides, over q, k, v and out as
    `strides` describes them: the fp32 one, or the wide bf16 one (bf16 at
    d > 128). `strides` holds 12 element strides, per operand those of
    batch, head and row (columns are unit), each a multiple of 16 bytes;
    `dims` = (batch, heads, q_len, kv_len, head_dim). The operands go to
    the kernel as TMA tensor maps (`wide_geometry`); where the dtype's plan
    (`f32_plan` or `wide_plan`) splits the K/V range, the kernel writes
    fp32 partials and the merge kernel combines them into `out`."""
    source, plan_fn = (("flash_attention_f32", f32_plan) if q.dtype == torch.float32
                       else ("flash_attention_wide", wide_plan))
    _check_strided_rows(source, [
        (n, tuple(strides[3 * i:3 * i + 3])) for i, n in enumerate("qkvo")],
        16 // q.element_size())
    b, h, q_len, kv_len, d = dims
    plan = plan_fn(b, h, q_len, kv_len, d, causal, sms=_sm_count(q.device))
    parts = _wide_fwd_launch(q, k, v, out, strides, dims, scale, causal, plan,
                             source=source)
    if parts is not None:
        _wide_merge_launch(*parts, out, strides[9:12], h, q_len, source=source)
        _build.launches[f"{source}_merge"] += 1


def _wide_fwd_launch(q, k, v, out, strides, dims, scale: float, causal: bool,
                     plan: WidePlan, source: str = "flash_attention_wide"):
    """The launch under `plan` of the split kernel of `source` (the wide
    bf16 one, or with "flash_attention_f32" the fp32 one): writes `out`,
    or with more than one split returns the fp32 partials (part_o,
    part_ml) it wrote into buffers allocated here."""
    b, h, q_len, kv_len, d = dims
    geometry = _geometry_argument(wide_geometry(tuple(strides), tuple(dims),
                                                q.element_size()))
    parts = None
    rows = plan.q_blocks * plan.block_q
    if plan.splits > 1:
        parts = (torch.empty((plan.splits, b * h, rows, d), dtype=torch.float32,
                             device=q.device),
                 torch.empty((plan.splits, b * h, rows, 2), dtype=torch.float32,
                             device=q.device))
    _launch(_build.load(source), f"fd_{source}_fwd",
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), geometry,
             *((t.data_ptr() for t in parts) if parts else (None, None)), rows, d,
             plan.splits, plan.tiles_per_split, scale * LOG2E, int(causal)), q.device)
    return parts


def _wide_merge_launch(part_o, part_ml, out, out_strides, heads: int,
                       q_len: int, source: str = "flash_attention_wide") -> None:
    """The merge kernel (`flash_wide_merge_kernel`, instanced in `source`
    for its output dtype): ``[splits, planes, rows, d]`` partials into
    `out` (bf16, or fp32 from "flash_attention_f32") at element strides
    (batch, head, row)."""
    splits, planes, rows, d = part_o.shape
    _launch(_build.load(source), f"fd_{source}_merge",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            (part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
             (ctypes.c_longlong * 3)(*out_strides), heads, planes, q_len, rows, d,
             splits), out.device)


def _strided_counter(dtype, d: int, packed: bool) -> str:
    """The `_build.launches` name of a launch of the strided kernels."""
    name = "flash_attention_f32" if dtype == torch.float32 else "flash_attention"
    if d in _WIDE_HEAD_DIMS:
        name += "_wide"
    return name + ("_bsnd_fwd" if packed else "_fwd")


class TmaGeometry(NamedTuple):
    """One operand as its 4-D TMA tensor map sees it: `dims` = (columns of
    a head, heads, rows, batches), innermost first; `strides` = the byte
    strides of heads, rows and batches; `box` = the tile one load or store
    moves, in elements of each dim."""
    dims: tuple
    strides: tuple
    box: tuple


def _tma_geometry(d, heads, rows, batches, head_stride, row_stride,
                  batch_stride, box_rows, esize: int = 2) -> TmaGeometry:
    """Strides in elements of `esize` bytes (2: bf16, boxes of PANEL_COLS
    columns; 4: fp32, boxes of 32 columns, 128 bytes either way). A
    dimension of extent 1 is given the stride of a contiguous tensor (its
    own never enters an address); every other one must be a positive
    multiple of 16 bytes, as TMA demands."""
    if d % PANEL_COLS:
        raise ValueError(f"head dim {d} is not a multiple of {PANEL_COLS}")
    per16 = 16 // esize
    strides = []
    for extent, stride, dense in ((heads, head_stride, d),
                                  (rows, row_stride, heads * d),
                                  (batches, batch_stride, rows * heads * d)):
        if extent == 1:
            stride = dense
        if stride <= 0 or stride % per16 or esize * stride >= 1 << 40:
            raise ValueError(f"stride {stride} of an extent of {extent} is not a "
                             f"positive multiple of {per16} elements below 2^40 bytes")
        strides.append(esize * stride)
    dims = (d, heads, rows, batches)
    if min(dims) < 1 or max(dims) > 1 << 32 or not 1 <= box_rows <= 256:
        raise ValueError(f"dims {dims}, box rows {box_rows}")
    return TmaGeometry(dims, tuple(strides), (128 // esize, 1, box_rows, 1))


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


# The wide kernel (`csrc/flash_attention_wide.cu`): K/V tiles, a warpgroup's
# q rows and every TMA box are WIDE_ROWS rows; a block holds 128 q rows (two
# warpgroups of 64) at d <= 256 and 64 above, where its two warpgroups split
# the columns (`WideLayout::kBlockQ` in the source, which refuses partial
# buffers of any other row count). One block an SM runs at once; H100_SMS
# is the card's SM count.
WIDE_ROWS = 64
H100_SMS = 132
# the fewest K/V tiles a split walks: at one tile (64 keys) a block's fixed
# cost (Q's load, the ring's fill, its fp32 partial rows) and the merge's
# reads outweigh the parallelism (`scripts/bench_flash_wide.py --splits`)
MIN_SPLIT_TILES = 2


class WidePlan(NamedTuple):
    """How the wide kernel covers one attention: `blocks` = q_blocks *
    planes * splits blocks of `block_q` q rows, block s of a q block over
    K/V tiles [s * tiles_per_split, (s + 1) * tiles_per_split) of the
    `kv_tiles`."""
    block_q: int
    q_blocks: int
    kv_tiles: int
    splits: int
    tiles_per_split: int
    blocks: int


def _split_plan(block_q: int, slots: int, batch: int, heads: int, q_len: int,
                kv_len: int, splits: Optional[int]) -> WidePlan:
    """q blocks of `block_q` rows over K/V tiles of WIDE_ROWS keys; where
    the q blocks of all planes leave some of the `slots` blocks one wave
    holds idle, the K/V tiles are split across blocks: as many splits as
    that wave holds while each walks at least MIN_SPLIT_TILES tiles,
    rounded so that the splits hold equal tile counts and none is empty
    (under the causal mask a q block splits its own live tiles the same
    way, and late splits may hold none). `splits` forces a count, rounded
    the same way."""
    q_blocks = -(-q_len // block_q)
    tiles = -(-kv_len // WIDE_ROWS)
    items = q_blocks * batch * heads
    if splits is None:
        splits = max(1, min(slots // items, tiles // MIN_SPLIT_TILES))
    per = -(-tiles // max(1, min(splits, tiles)))
    splits = -(-tiles // per)
    return WidePlan(block_q, q_blocks, tiles, splits, per, items * splits)


@functools.lru_cache(maxsize=256)
def wide_plan(batch: int, heads: int, q_len: int, kv_len: int, d: int,
              causal: bool = False, sms: int = H100_SMS,
              splits: Optional[int] = None) -> WidePlan:
    """The wide bf16 kernel's launch for one shape (`_split_plan`): one
    block an SM, so a wave is `sms` blocks (a block more would run alone
    in a second wave). `splits` forces a count (tests, benchmarks)."""
    block_q = WIDE_ROWS * (1 if d > 256 else 2)
    return _split_plan(block_q, sms, batch, heads, q_len, kv_len, splits)


# The fp32 kernel (`csrc/flash_attention_f32.cu`): 64 q rows a block and
# K/V tiles of 64 keys at every head dim; two blocks an SM at d <= 128
# (`F32Layout::kBlocksPerSm`), one above.
F32_ROWS = WIDE_ROWS


def f32_blocks_per_sm(d: int) -> int:
    return 2 if d <= 128 else 1


@functools.lru_cache(maxsize=256)
def f32_plan(batch: int, heads: int, q_len: int, kv_len: int, d: int,
             causal: bool = False, sms: int = H100_SMS,
             splits: Optional[int] = None) -> WidePlan:
    """The fp32 kernel's launch for one shape (`_split_plan`): a wave is
    the blocks all SMs hold at once. `splits` forces a count (tests,
    benchmarks)."""
    return _split_plan(F32_ROWS, sms * f32_blocks_per_sm(d), batch, heads, q_len,
                       kv_len, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def wide_geometry(strides: tuple, dims: tuple, esize: int = 2) -> tuple:
    """q, k, v, o as the strided kernels' tensor maps see them (the wide
    bf16 one's, or at `esize` 4 the fp32 one's), from the 12 element
    strides (batch, head, row of each) and dims (batch, heads, q_len,
    kv_len, d) the strided launch takes. Where every operand's
    planes lie evenly apart (contiguous [B, H, S, d], or one head), the
    heads fold into the batch dim, as `bhsd_geometry` has it; otherwise
    (packed rows, a head d columns into a row) each keeps its own."""
    b, h, q_len, kv_len, d = dims
    ops = [strides[3 * i:3 * i + 3] for i in range(4)]
    fold = h == 1 or all(sb == h * sh for sb, sh, _ in ops)
    out = []
    for (sb, sh, sr), rows in zip(ops, (q_len, kv_len, kv_len, q_len)):
        if fold:
            out.append(_tma_geometry(d, 1, rows, b * h, d, sr, sh if h > 1 else sb,
                                     WIDE_ROWS, esize))
        else:
            out.append(_tma_geometry(d, h, rows, b, sh, sr, sb, WIDE_ROWS, esize))
    return tuple(out)


def wide_partials(q, k, v, scale: float, causal: bool, plan: WidePlan):
    """The split partials the wide kernel writes, in plain PyTorch, for
    ``[B, H, S, d]`` operands: for split s of each q block, over its K/V
    tiles, the rows' unnormalised fp32 output (p in v's dtype before p.v),
    max m of the fp32 scores scaled by scale * log2 e (masked ones
    `DEFAULT_MASK_VALUE`) and sum l of 2^(score - m). Returns part_o
    ``[splits, B*H, rows, d]`` and part_ml ``[splits, B*H, rows, 2]`` with
    the kernel's padded rows (a split with no tile: m masked, l and o 0)."""
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    rows = plan.q_blocks * plan.block_q
    part_o = torch.zeros((plan.splits, b * h, rows, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.zeros((plan.splits, b * h, rows, 2), dtype=torch.float32,
                          device=q.device)
    part_ml[..., 0] = DEFAULT_MASK_VALUE
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if causal:
        above = torch.ones((q_len, kv_len), dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, DEFAULT_MASK_VALUE)
    s = s.reshape(b * h, q_len, kv_len)
    vf = v.reshape(b * h, kv_len, d)
    for qb in range(plan.q_blocks):
        r0, r1 = qb * plan.block_q, min((qb + 1) * plan.block_q, q_len)
        n = kv_tiles(r0, kv_len, causal, plan.block_q, WIDE_ROWS)
        for split in range(plan.splits):
            t0, t1 = split * plan.tiles_per_split, min((split + 1) * plan.tiles_per_split, n)
            if t1 <= t0:
                continue
            c0, c1 = t0 * WIDE_ROWS, min(t1 * WIDE_ROWS, kv_len)
            sc = s[:, r0:r1, c0:c1]
            m = sc.amax(dim=-1, keepdim=True)
            p = torch.exp2(sc - m)
            part_ml[split, :, r0:r1, 0] = m[..., 0]
            part_ml[split, :, r0:r1, 1] = p.sum(dim=-1)
            part_o[split, :, r0:r1] = torch.matmul(p.to(v.dtype).float(),
                                                   vf[:, c0:c1].float())
    return part_o, part_ml


def merge_wide_partials(part_o, part_ml):
    """The merge kernel's plain version: ``[splits, planes, rows, d]``
    partials and their ``[..., 2]`` (max, sum) into the fp32 output
    ``[planes, rows, d]``, o = sum_s 2^(m_s - M) o_s / sum_s 2^(m_s - M) l_s
    with M the rows' largest m_s."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    w = torch.exp2(m - m.amax(dim=0))
    total = (w * l).sum(dim=0)
    return (w[..., None] * part_o).sum(dim=0) * (1.0 / total)[..., None]


def wide_attention_split(q, k, v, scale: float, causal: bool, plan: WidePlan):
    """The wide kernel's split-and-merge path in plain PyTorch
    (`wide_partials`, then `merge_wide_partials`), in q's dtype."""
    b, h, q_len, d = q.shape
    merged = merge_wide_partials(*wide_partials(q, k, v, scale, causal, plan))
    return merged.reshape(b, h, -1, d)[:, :, :q_len].to(q.dtype)


def tf32_round(x):
    """fp32 `x` rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest, ties
    away from zero, the 13 low mantissa bits cleared (inf and NaN kept)."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x):
    """(big, small): big = tf32(x), small = tf32(x - big), both fp32
    tensors of TF32 values (the fp32 kernel's operand split)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def tf32_matmul(a, b, products: int = 3):
    """a @ b as the fp32 kernel's tensor cores take it: with products=3,
    3xTF32, small(a).big(b) + big(a).small(b) + big(a).big(b) summed in
    that order in fp32 (each TF32 product is exact in fp32); with
    products=1, big(a).big(b) alone (single TF32)."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    if products == 1:
        return torch.matmul(ab, bb)
    return torch.matmul(as_, bb) + torch.matmul(ab, bs) + torch.matmul(ab, bb)


def f32_partials(q, k, v, scale: float, causal: bool, plan: WidePlan, *,
                 products: int = 3, visited=None):
    """The fp32 kernel's blocks in plain PyTorch, for ``[B, H, S, d]`` fp32
    operands: for split s of each q block of F32_ROWS rows, over its K/V
    tiles of WIDE_ROWS keys (rows past kv_len zero, as TMA fills them), q
    scaled by scale * log2 e in fp32, scores by `tf32_matmul` (at d > 128
    the two column halves' score halves added, as the block's two halves
    of warps do), columns past kv_len and above the causal diagonal
    (top-left) `DEFAULT_MASK_VALUE`, the online softmax in base 2, p kept
    in fp32 and p.v by `tf32_matmul`. Returns part_o ``[splits, B*H, rows,
    d]`` (unnormalised) and part_ml ``[splits, B*H, rows, 2]`` (max, sum),
    padded rows included (a split with no tile: m masked, l and o 0).
    `visited`, a list, gets one ``(q0, split, k0)`` per tile a block
    walks."""
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    rows = plan.q_blocks * plan.block_q
    tile = WIDE_ROWS
    halves = 2 if d > 128 else 1
    f32 = dict(dtype=torch.float32, device=q.device)
    qs = torch.zeros((b * h, rows, d), **f32)
    qs[:, :q_len] = q.reshape(b * h, q_len, d).float() * (scale * LOG2E)
    pad = plan.kv_tiles * tile
    ks = torch.zeros((b * h, pad, d), **f32)
    vs = torch.zeros((b * h, pad, d), **f32)
    ks[:, :kv_len] = k.reshape(b * h, kv_len, d).float()
    vs[:, :kv_len] = v.reshape(b * h, kv_len, d).float()
    part_o = torch.zeros((plan.splits, b * h, rows, d), **f32)
    part_ml = torch.zeros((plan.splits, b * h, rows, 2), **f32)
    part_ml[..., 0] = DEFAULT_MASK_VALUE
    cut = d // halves
    for qb in range(plan.q_blocks):
        r0 = qb * plan.block_q
        qb_rows = torch.arange(r0, r0 + plan.block_q, device=q.device)
        qg = qs[:, r0:r0 + plan.block_q]
        n = kv_tiles(r0, kv_len, causal, plan.block_q, tile)
        for split in range(plan.splits):
            t0, t1 = split * plan.tiles_per_split, min((split + 1) * plan.tiles_per_split, n)
            acc = torch.zeros((b * h, plan.block_q, d), **f32)
            m = torch.full((b * h, plan.block_q, 1), DEFAULT_MASK_VALUE, **f32)
            l = torch.zeros((b * h, plan.block_q, 1), **f32)
            for t in range(t0, t1):
                k0 = t * tile
                if visited is not None:
                    visited.append((r0, split, k0))
                kt, vt = ks[:, k0:k0 + tile], vs[:, k0:k0 + tile]
                s = tf32_matmul(qg[..., :cut], kt[..., :cut].transpose(-1, -2), products)
                if halves == 2:
                    s = s + tf32_matmul(qg[..., cut:], kt[..., cut:].transpose(-1, -2),
                                        products)
                cols = torch.arange(k0, k0 + tile, device=q.device)
                keep = (cols < kv_len)[None, :]
                if causal:
                    keep = keep & (cols[None, :] <= qb_rows[:, None])
                s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp2(s - m_new)
                alpha = torch.exp2(m - m_new)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + tf32_matmul(p, vt, products)
                m = m_new
            part_o[split, :, r0:r0 + plan.block_q] = acc
            part_ml[split, :, r0:r0 + plan.block_q, 0] = m[..., 0]
            part_ml[split, :, r0:r0 + plan.block_q, 1] = l[..., 0]
    return part_o, part_ml


def flash_attention_f32_tiled(q, k, v, scale: float, causal: bool = False, *,
                              plan: Optional[WidePlan] = None, products: int = 3,
                              visited=None):
    """The fp32 kernel's schedule and arithmetic in plain PyTorch, for
    tests: ``[B, H, S, d]`` fp32 operands through `f32_partials` under
    `plan` (default: `f32_plan` on the card's SM count), then o = acc *
    (1 / l) for one split or `merge_wide_partials` (the merge kernel's
    plain version) for more. `products=1` takes single-TF32 products."""
    b, h, q_len, d = q.shape
    if plan is None:
        plan = f32_plan(b, h, q_len, k.shape[2], d, causal)
    part_o, part_ml = f32_partials(q, k, v, scale, causal, plan, products=products,
                                   visited=visited)
    if plan.splits == 1:
        merged = part_o[0] * (1.0 / part_ml[0, ..., 1:])
    else:
        merged = merge_wide_partials(part_o, part_ml)
    return merged.reshape(b, h, -1, d)[:, :, :q_len]


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
    """Flash attention. A CUDA tensor launches a kernel (bf16 or fp32, head
    dim 64, 128 or 192 ... 512 in steps of 64, contiguous ``[B, H, S, d]``)
    and raises on anything the kernels do not take; under autograd its
    gradient is that of `attention_reference` (`flash_attention_function`).
    A CPU tensor computes `attention_reference`."""
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
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    _check_head_dim("flash_attention", d)
    _check_kernel_inputs("flash_attention", q, (("q", q), ("k", k), ("v", v)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if k.shape != (b, h, kv_len, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if causal and q_len != kv_len:
        # the TPU kernel masks top-left (q_idx >= k_idx) while its reference
        # masks bottom-right; they agree only for square score matrices
        raise ValueError("flash_attention: causal needs q_len == kv_len")
    out = torch.empty_like(q)
    if q.dtype == torch.float32 or d in _WIDE_HEAD_DIMS:
        strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
        _strided_launch(q, k, v, out, strides,
                        (b, h, q_len, kv_len, d), scale, causal)
        _build.launches[_strided_counter(q.dtype, d, False)] += 1
        return out
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


def _flash_gate(q_len: int, kv_len: int, head_dim: int,
                packed: bool = False) -> bool:
    """Long sequences on both sides at a head dim % 64 == 0, as JAX's gate
    (`multi_head_attention`, `attention_packed`). JAX also asks for
    lengths that are a multiple of 128 and, in the BHSD kernel, for K/V of
    at most 512 Ki elements a plane (what fits the TPU's VMEM). At d = 64
    and 128 the card's kernels mask partial tiles and stream K/V, so the
    port keeps neither condition there and serves a superset; at the wide
    head dims it keeps both, so it takes exactly JAX's shapes (and the
    launch refuses d > 512)."""
    if q_len < _MIN_FLASH_SEQ or kv_len < _MIN_FLASH_SEQ or head_dim % 64:
        return False
    if head_dim in _FLASH_HEAD_DIMS:
        return True
    return (q_len % _WIDE_LEN_MULTIPLE == 0 and kv_len % _WIDE_LEN_MULTIPLE == 0
            and (packed or kv_len * head_dim <= _MAX_WIDE_KV_ELEMS))


def flash_eligible(q, k) -> bool:
    """The ``[B, H, S, d]`` shapes the flash kernels serve: every UNet
    self-attention (d=64), the LLaMA causal prefill at >= 1024 tokens
    (d=128) and the VAE mid-attention at 1024 tokens (d=512)."""
    return _flash_gate(q.shape[2], k.shape[2], q.shape[-1])


def multi_head_attention(q, k, v, *, scale: Optional[float] = None,
                         causal: bool = False, use_flash: Optional[bool] = None):
    """Scaled dot-product attention over ``[B, H, S, D]`` tensors.

    Long attention that `flash_eligible` admits goes to `flash_attention`
    (a kernel on CUDA); long non-causal score matrices to `chunked_attention`; the rest
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
    ``[b, skv, n*d]`` -> ``[b, sq, n*d]``. A CUDA tensor launches a kernel
    (bf16 or fp32, d = 64, 128 or 192 ... 512 in steps of 64, packed rows as `_check_packed_strides`
    describes) and raises on anything it does not take; a CPU tensor computes
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
    if q.dim() == 3 and heads > 0 and q.shape[2] % heads == 0:
        _check_head_dim("flash_attention_packed", q.shape[2] // heads)
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_packed_strides(name, t, f)
    out = torch.empty((b, sq, f), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32 or d in _WIDE_HEAD_DIMS:
        # batch, head, row: a head is d columns into a packed row
        strides = [x for t in (q, k, v, out) for x in (t.stride(0), d, t.stride(1))]
        _strided_launch(q, k, v, out, strides,
                        (b, heads, sq, skv, d), scale, False)
        _build.launches[_strided_counter(q.dtype, d, True)] += 1
        return out
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
    attention on both sides that the gate admits (every UNet
    self-attention; JAX's packed gate has no K/V cap) goes to
    `flash_attention_packed`; the rest (the 77-token cross-attention) to
    `einsum_bsnd`."""
    d = q.shape[2] // heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _flash_gate(q.shape[1], k.shape[1], d, packed=True):
        return flash_attention_packed(q, k, v, heads, scale)
    return einsum_bsnd(q, k, v, heads, scale)
