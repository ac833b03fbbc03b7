"""NF4 dequant-matmul: ``y = x @ dequant(W)``, W half-row packed NF4.

Counterpart of `faithdiff_tpu/ops/nf4_matmul.py` (`_nf4_matvec_kernel`).
A CUDA tensor goes to the hand-written kernels (`csrc/nf4_matmul.cu`),
which decode the packed codes in registers / shared memory so the decoded
weight never reaches device memory; a CPU tensor goes to
`nf4_matmul_reference`, the same arithmetic in plain torch.

Arithmetic (the TPU kernel's): each code decodes through the 16-entry
`NF4_CODE` table, is multiplied by its block's absmax in fp32 and rounded
to x's dtype; products are summed in fp32 and the sum is cast to x's dtype.

Two routes, by the rows M of x: `nf4_gemv` (M <= 8, decode) and
`nf4_gemm` (M > 8: the prefill, decode batches of 9+ images).
`plan_nf4_gemv` and `plan_nf4_gemm` make every launch decision of their
route from the shape alone; `nf4_gemv_tiled` and `nf4_gemm_tiled` walk
those schedules in plain PyTorch for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.quantize import NF4_BLOCK, NF4_PACK_HALFROW, NF4Weight, _dequant_nf4_oi
from . import _build

# decode route: most rows of x, a block's rows (one 16-row mma tile) and
# warps (they split K), and the card's shared memory a block may use
# (227 KB). `csrc/nf4_matmul.cu` lays its shared memory out by the same
# formulas as `gemv_scale_bytes`, `gemv_ring_bytes` and the plan's x bytes
# and rejects a launch given less; a card test holds the two together.
GEMV_MAX_M = 8
GEMV_ROWS = 16
GEMV_WARPS = 8
SMEM_LIMIT = 227 * 1024
# x is staged whole at block start for M >= 4, or up to this many bytes of
# it; else it goes a piece a lane a step through the warps' rings. Timed
# both ways on an H100 at the 13B shapes, whole x won at in = 5120 for
# every M and lost at M = 2-3, in = 13824, where 55-83 KB of x are staged
# before any work.
X_WHOLE_BYTES = 32 * 1024
X_WHOLE_MIN_M = 4
# K steps (quads) in flight in a warp's shared-memory ring (the kernel's
# kStages)
STAGES = 4
# packed bytes of a row one warp reads in one K step: four lanes (one mma
# thread group) x one 16-byte vector each
QUAD_BYTES = 64


def nf4_matmul_reference(x: torch.Tensor, q: NF4Weight) -> torch.Tensor:
    """Plain version: decode and scale in fp32, cast to x's dtype, matmul
    with an fp32 result, cast to x's dtype."""
    w = _dequant_nf4_oi(q, torch.float32).to(x.dtype)        # [out, in]
    return torch.matmul(x.float(), w.float().T).to(x.dtype)


class Nf4GemvPlan(NamedTuple):
    """How one decode-route launch runs. A block owns GEMV_ROWS output rows
    (one mma tile) over the whole K; its GEMV_WARPS warps split K by quads
    (64 packed bytes of a row: 16-byte vectors 4q .. 4q+3, one per lane of
    an mma thread group), warp w taking quads w, w + W, ... (at most
    `quads_per_warp`), and fold their fp32 partial tiles in warp order. A
    warp takes a quad a step (block b from step b mod its step count on),
    with the next STAGES - 1 quads' weights in flight to shared memory; x
    and the block's absmax rows are staged there once."""
    m: int
    in_f: int
    out_f: int
    x_whole: bool            # x staged whole at block start (else through the rings)
    full: bool               # no row past out_f, no partial last quad: no masks
    quads: int               # ceil(in / 128): quads of a packed row
    quads_per_warp: int
    grid: int
    scale_bytes: int         # the block's absmax rows, f32, odd row stride
    x_bytes: int             # x staged whole: m rows, each padded by 16 bytes
    ring_bytes: int          # the warps' rings of packed vectors (and x)
    fold_bytes: int          # the warps' partial tiles, fp32 [16, 8]
    smem_bytes: int          # dynamic shared memory: scales + x + rings, or the fold

    rows = GEMV_ROWS
    warps = GEMV_WARPS

    @property
    def threads(self) -> int:
        return 32 * self.warps

    def warp_quads(self, w: int) -> range:
        """The quads warp w takes."""
        return range(w, self.quads, self.warps)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemv_ring_bytes(m: int, x_whole: bool) -> int:
    """The warps' rings of STAGES K steps: a step holds the 2 packed
    vectors (rows g, g + 8) of each of 32 lanes and, unless x is staged
    whole, four 16-byte pieces of x (16 high and 16 low columns of a
    vector) for each of the 4 m lanes whose mma row g < m."""
    return GEMV_WARPS * STAGES * (2 * 32 + (0 if x_whole else 4 * 4 * m)) * 16


def gemv_scale_bytes(in_f: int) -> int:
    """The block's absmax rows in shared memory: an odd row stride (the 8
    rows a thread group reads fall in 8 banks), padded to 16 bytes."""
    return _cdiv(GEMV_ROWS * ((in_f // NF4_BLOCK) | 1) * 4, 16) * 16


@functools.lru_cache(maxsize=1024)
def plan_nf4_gemv(m: int, in_f: int, out_f: int) -> Nf4GemvPlan:
    """The decode route's launch plan for x [m, in_f] (1 <= m <= 8) against
    an [out_f, in_f / 2] half-row packed weight. x is staged whole where it
    fits shared memory and m >= X_WHOLE_MIN_M or it is at most
    X_WHOLE_BYTES, else through the rings; raises where neither fits. The
    warps take the row's quads in turn (a warp past the last quad has
    nothing to do). Cached by its arguments."""
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"plan_nf4_gemv: m={m}, the decode route takes 1..{GEMV_MAX_M}")
    if in_f <= 0 or in_f % NF4_BLOCK or out_f <= 0:
        raise ValueError(f"plan_nf4_gemv: in={in_f}, out={out_f}")
    scale = gemv_scale_bytes(in_f)
    whole = m * (2 * in_f + 16)           # x rows, each padded by 16 bytes
    x_whole = (scale + whole + gemv_ring_bytes(m, True) <= SMEM_LIMIT
               and (m >= X_WHOLE_MIN_M or 2 * m * in_f <= X_WHOLE_BYTES))
    x_bytes = whole if x_whole else 0
    ring = gemv_ring_bytes(m, x_whole)
    if scale + x_bytes + ring > SMEM_LIMIT:
        raise ValueError(f"plan_nf4_gemv: {scale + ring} bytes of shared memory at m={m}, "
                         f"in={in_f}, more than {SMEM_LIMIT}")
    quads = _cdiv(in_f // 2, QUAD_BYTES)
    fold = GEMV_WARPS * GEMV_ROWS * 8 * 4
    return Nf4GemvPlan(m=m, in_f=in_f, out_f=out_f, x_whole=x_whole,
                       full=out_f % GEMV_ROWS == 0 and (in_f // 2) % QUAD_BYTES == 0,
                       quads=quads, quads_per_warp=_cdiv(quads, GEMV_WARPS),
                       grid=_cdiv(out_f, GEMV_ROWS), scale_bytes=scale, x_bytes=x_bytes,
                       ring_bytes=ring, fold_bytes=fold,
                       smem_bytes=max(scale + x_bytes + ring, fold))


def gemv_k_order(plan: Nf4GemvPlan, w: int) -> torch.Tensor:
    """Columns of the [out, in] weight (and of x) in the order warp w's
    mma instructions take them as k: by quad (one a step), then for each
    4-byte word of a lane's vector one mma over the high-nibble columns and
    one over the low-nibble columns; within an mma, k slots 2t, 2t+1 are
    columns 4j, 4j+1 of lane t's word j and slots 8+2t, 9+2t columns
    4j+2, 4j+3. Vectors past the packed row (a partial last quad) are left
    out, as the kernel zeroes them."""
    half = plan.in_f // 2
    n_vec = half // 16
    cols = []
    for quad in plan.warp_quads(w):
        for word in range(4):
            for base in (0, half):
                for slots in ((0, 1), (2, 3)):
                    for tig in range(4):
                        vec = 4 * quad + tig
                        if vec < n_vec:
                            c = base + 16 * vec + 4 * word
                            cols += [c + slots[0], c + slots[1]]
    return torch.tensor(cols, dtype=torch.long)


def nf4_gemv_tiled(x: torch.Tensor, q: NF4Weight, plan: Nf4GemvPlan) -> torch.Tensor:
    """The decode route's schedule in plain PyTorch (tests only): each
    warp's quads, gathered in the kernel's lane-to-column order, give an
    fp32 partial [M, out] from the weights decoded as the kernel decodes
    them; the partials are folded in warp order and the sum cast to x's
    dtype. Row blocks are independent, so all rows go at once. The order
    of the fp32 sums inside a warp's partial (the kernel's step rotation,
    the mma's own) is not reproduced."""
    in_f, out_f = q.shape
    if (plan.in_f, plan.out_f) != (in_f, out_f) or x.shape[-1] != in_f:
        raise ValueError(f"nf4_gemv_tiled: plan for {(plan.in_f, plan.out_f)}, "
                         f"x {tuple(x.shape)}, weight {q.shape}")
    x2 = x.reshape(-1, in_f)
    if x2.shape[0] != plan.m:
        raise ValueError(f"nf4_gemv_tiled: {x2.shape[0]} rows, plan for {plan.m}")
    w = _dequant_nf4_oi(q, torch.float32).to(x.dtype).float()     # [out, in]
    acc = None
    for warp in range(plan.warps):
        k = gemv_k_order(plan, warp)
        part = torch.matmul(x2.float()[:, k], w[:, k].T)
        acc = part if acc is None else acc + part
    return acc.to(x.dtype).reshape(x.shape[:-1] + (out_f,))


# prefill route: weight rows a block (two consumer warpgroups of 64), packed
# bytes of a row a K step (64 high- and 64 low-nibble columns), the x rows a
# tile may have (the kernel's instances: multiples of 16 up to 256), the
# most ring stages, and the dynamic shared memory a block may take (the
# rest of the 227 KB holds the code table). `csrc/nf4_matmul.cu` lays its
# shared memory out by the same formulas (`gemm_stage_bytes`) and refuses a
# launch that disagrees with them or with the shape.
GEMM_ROWS = 128
GEMM_STEP_BYTES = 64
GEMM_N_TILES = tuple(range(16, 257, 16))
GEMM_MAX_STAGES = 4
GEMM_SMEM_LIMIT = SMEM_LIMIT - 1024
GEMM_THREADS = 384
# the card the plan fills: an H100 SXM's streaming multiprocessors, one
# block each (a block takes the SM's registers)
GEMM_SMS = 132
# a block's time per K step, in x rows' worth of tensor-core work: n_tile
# rows plus what a step costs whatever the rows (the decode, the waits).
# Every tile timed at the 13B shapes on an NVIDIA H100 80GB HBM3 at 700 W
# (`scripts/bench_nf4_decode.py --tiles`): the tile this picks was the
# fastest at M = 640 and 1244 on all three shapes, and at M = 1024 at most
# 7% behind the fastest tile.
GEMM_STEP_ROWS = 64
GEMM_EPI_PITCH = 272                # bytes of a y row in the epilogue's transpose


class Nf4GemmPlan(NamedTuple):
    """How one prefill-route launch runs. Block b owns weight rows
    [128 w, 128 w + 128) with w = b // m_tiles and rows of x [n_tile i,
    n_tile i + n_tile) with i = b % m_tiles, over the whole K: `steps` K
    steps of GEMM_STEP_BYTES packed bytes of each row, the high-nibble
    columns [64 s, 64 s + 64) and the low-nibble ones in/2 + the same, each
    step one stage of a `stages`-deep ring. Its tensor-core products are
    wgmma m64nNk16 with N = the pieces of `n_parts`."""
    m: int
    in_f: int
    out_f: int
    n_tile: int              # rows of x a block
    n_parts: tuple           # the wgmma widths n_tile is issued as, widest first
    stages: int
    steps: int               # ceil(in / 128): K steps
    w_tiles: int             # ceil(out / 128)
    m_tiles: int             # ceil(m / n_tile)
    grid: int                # w_tiles * m_tiles blocks
    waves: float             # grid / GEMM_SMS
    stage_bytes: int         # two x boxes, the packed box, the scales
    epilogue_bytes: int      # the y^T transpose, over the ring
    smem_bytes: int          # dynamic shared memory: alignment slack + ring + barriers
    full: bool               # no row past m or out_f in any tile: no masks

    rows = GEMM_ROWS
    threads = GEMM_THREADS

    def tiles(self):
        """(weight row, x row) where each block's tile starts, by block."""
        return [((b // self.m_tiles) * GEMM_ROWS, (b % self.m_tiles) * self.n_tile)
                for b in range(self.grid)]

    def step_columns(self, s: int):
        """The weight (and x) columns of K step s: the high-nibble ones,
        then the low-nibble ones; the last step of a ragged half is cut."""
        half = self.in_f // 2
        hi = range(GEMM_STEP_BYTES * s, min(GEMM_STEP_BYTES * (s + 1), half))
        return list(hi) + [half + c for c in hi]


def gemm_stage_bytes(n_tile: int) -> int:
    """One ring stage: the x boxes of a step's high and low columns
    ([n_tile, 64] bf16 each), the block's packed bytes ([128, 64]) and its
    rows' scales (4 f32 a row)."""
    return 2 * n_tile * 128 + GEMM_ROWS * GEMM_STEP_BYTES + GEMM_ROWS * 16


def wgmma_widths(n_tile: int) -> tuple:
    """The wgmma widths a tile of n_tile rows of x is issued as, widest
    first (the kernel's `wgmma_x_rows`)."""
    parts, left = [], n_tile
    for w in (128, 64, 32, 16):
        while left >= w:
            parts.append(w)
            left -= w
    return tuple(parts)


@functools.lru_cache(maxsize=1024)
def plan_nf4_gemm(m: int, in_f: int, out_f: int) -> Nf4GemmPlan:
    """The prefill route's launch plan for x [m, in_f] (m > 8) against an
    [out_f, in_f / 2] half-row packed weight. The tile's x rows are the
    one of GEMM_N_TILES with the least estimated time, waves of blocks on
    GEMM_SMS SMs times a block's time per step (n_tile + GEMM_STEP_ROWS),
    the wider on a tie (`gemm_plan_for_tile` makes the rest of the plan).
    Raises on what the kernel does not take. Cached by its arguments."""
    w_tiles = _cdiv(out_f, GEMM_ROWS)

    def cost(n):
        return (_cdiv(w_tiles * _cdiv(m, n), GEMM_SMS) * (n + GEMM_STEP_ROWS), -n)

    return gemm_plan_for_tile(m, in_f, out_f, min(GEMM_N_TILES, key=cost))


def gemm_plan_for_tile(m: int, in_f: int, out_f: int, n_tile: int) -> Nf4GemmPlan:
    """The prefill route's plan with n_tile rows of x a block: the ring
    takes as many stages as fit, up to GEMM_MAX_STAGES. `plan_nf4_gemm`
    picks n_tile; `scripts/bench_nf4_decode.py --tiles` times the others.
    Raises on what the kernel does not take."""
    if m <= GEMV_MAX_M:
        raise ValueError(f"plan_nf4_gemm: m={m}, the prefill route takes m > {GEMV_MAX_M}")
    if in_f <= 0 or in_f % NF4_BLOCK or out_f <= 0:
        raise ValueError(f"plan_nf4_gemm: in={in_f}, out={out_f}")
    if n_tile not in GEMM_N_TILES:
        raise ValueError(f"plan_nf4_gemm: {n_tile} rows of x a tile, the kernel takes "
                         f"{GEMM_N_TILES}")
    stage = gemm_stage_bytes(n_tile)
    stages = min(GEMM_MAX_STAGES, (GEMM_SMEM_LIMIT - 1024) // (stage + 16))
    w_tiles = _cdiv(out_f, GEMM_ROWS)
    m_tiles = _cdiv(m, n_tile)
    grid = w_tiles * m_tiles
    return Nf4GemmPlan(m=m, in_f=in_f, out_f=out_f, n_tile=n_tile,
                       n_parts=wgmma_widths(n_tile), stages=stages,
                       steps=_cdiv(in_f // 2, GEMM_STEP_BYTES), w_tiles=w_tiles,
                       m_tiles=m_tiles, grid=grid, waves=grid / GEMM_SMS,
                       stage_bytes=stage, epilogue_bytes=n_tile * GEMM_EPI_PITCH,
                       smem_bytes=1024 + stages * stage + 16 * stages,
                       full=out_f % GEMM_ROWS == 0 and m % n_tile == 0)


def nf4_gemm_tiled(x: torch.Tensor, q: NF4Weight, plan: Nf4GemmPlan) -> torch.Tensor:
    """The prefill route's schedule in plain PyTorch (tests only): each
    block's tile of y^T summed in fp32 over its K steps in order (in a
    step, the high-nibble columns, then the low-nibble ones), from the
    weights decoded as the kernel decodes them, cast to x's dtype. The
    order of the fp32 sums inside a step (the wgmma's own) is not
    reproduced."""
    in_f, out_f = q.shape
    if (plan.in_f, plan.out_f) != (in_f, out_f) or x.shape[-1] != in_f:
        raise ValueError(f"nf4_gemm_tiled: plan for {(plan.in_f, plan.out_f)}, "
                         f"x {tuple(x.shape)}, weight {q.shape}")
    x2 = x.reshape(-1, in_f).float()
    if x2.shape[0] != plan.m:
        raise ValueError(f"nf4_gemm_tiled: {x2.shape[0]} rows, plan for {plan.m}")
    w = _dequant_nf4_oi(q, torch.float32).to(x.dtype).float()     # [out, in]
    cols = [torch.tensor(plan.step_columns(s), dtype=torch.long) for s in range(plan.steps)]
    y = torch.empty((plan.m, out_f), dtype=torch.float32, device=x.device)
    for r0, m0 in plan.tiles():
        xs = x2[m0:m0 + plan.n_tile]
        ws = w[r0:r0 + GEMM_ROWS]
        acc = torch.zeros((ws.shape[0], xs.shape[0]), dtype=torch.float32, device=x.device)
        for k in cols:
            acc += ws[:, k] @ xs[:, k].T
        y[m0:m0 + plan.n_tile, r0:r0 + GEMM_ROWS] = acc.T
    return y.to(x.dtype).reshape(x.shape[:-1] + (out_f,))


def launch_gemm(lib: ctypes.CDLL, x: torch.Tensor, q: NF4Weight, out: torch.Tensor,
                plan: Nf4GemmPlan, stream: int) -> int:
    """One launch of the prefill kernel by `plan` on operands the caller
    has checked; returns the entry point's cudaError_t code."""
    fn = lib.fd_nf4_gemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(x.data_ptr(), q.packed.data_ptr(), q.absmax.data_ptr(), out.data_ptr(),
              plan.m, plan.in_f, plan.out_f, plan.n_tile, plan.stages, plan.grid,
              plan.smem_bytes, int(plan.full), stream)


def nf4_matmul_kernel(x: torch.Tensor, q: NF4Weight) -> torch.Tensor:
    """Launch the CUDA kernel on x [..., in] (contiguous bf16 on the card)
    -> bf16 [..., out]: the decode route for up to 8 rows of x (planned by
    `plan_nf4_gemv`), the prefill route above (planned by
    `plan_nf4_gemm`). Raises on anything the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"nf4_matmul_kernel: x on {x.device}, the kernel runs on CUDA")
    if int(q.pack_format) != NF4_PACK_HALFROW:
        raise ValueError(f"nf4_matmul_kernel: pack_format {q.pack_format}, "
                         "the kernel takes the half-row layout only")
    in_f, out_f = q.shape
    if in_f % NF4_BLOCK:
        raise ValueError(f"nf4_matmul_kernel: in={in_f} is not a multiple of 64")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"nf4_matmul_kernel: x is {x.dtype}, the kernel takes bfloat16")
    if x.shape[-1] != in_f:
        raise ValueError(f"nf4_matmul_kernel: x {tuple(x.shape)} against in={in_f}")
    packed, absmax = q.packed, q.absmax
    if (packed.dtype != torch.uint8 or tuple(packed.shape) != (out_f, in_f // 2)
            or absmax.dtype != torch.float32
            or tuple(absmax.shape) != (out_f, in_f // NF4_BLOCK)):
        raise ValueError(
            f"nf4_matmul_kernel: packed {packed.dtype} {tuple(packed.shape)}, absmax "
            f"{absmax.dtype} {tuple(absmax.shape)} for shape {q.shape}")
    for name, t in (("x", x), ("packed", packed), ("absmax", absmax)):
        if t.device != x.device:
            raise ValueError(f"nf4_matmul_kernel: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"nf4_matmul_kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            # packed rows and x move as 16-byte vectors
            raise ValueError(f"nf4_matmul_kernel: {name} is not 16-byte aligned")
    lead = x.shape[:-1]
    m = x.numel() // in_f
    out = torch.empty(lead + (out_f,), dtype=torch.bfloat16, device=x.device)
    if m == 0 or out_f == 0:
        return out
    lib = _build.load("nf4_matmul")
    route = "nf4_gemv" if m <= GEMV_MAX_M else "nf4_gemm"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "nf4_gemv":
            p = plan_nf4_gemv(m, in_f, out_f)
            fn = lib.fd_nf4_gemv
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            code = fn(x.data_ptr(), packed.data_ptr(), absmax.data_ptr(), out.data_ptr(),
                      m, in_f, out_f, int(p.full), int(p.x_whole), p.grid, p.smem_bytes,
                      stream)
        else:
            code = launch_gemm(lib, x, q, out, plan_nf4_gemm(m, in_f, out_f), stream)
    _build.check(lib, code, route)
    _build.launches["nf4_matmul"] += 1
    _build.launches[route] += 1
    return out
