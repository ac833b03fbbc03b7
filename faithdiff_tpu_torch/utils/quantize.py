"""Weight quantisation (counterpart of `faithdiff_tpu/utils/quantize.py`).

- fp8 (`restore --use_fp8`): UNet weights stored as float8_e4m3fn, picked
  and rounded as the JAX package's `quantize_params_fp8` picks and rounds
  them; `models.layers.store_fp8_` holds them in a model and upcasts each
  where its layer runs. `make_delta` / `apply_delta` are the checkpoint
  delta utilities of the same module.

- int8: per-output-channel absmax, `values` int8 [in, out] and `scales`
  f32 [out], dequantised in the matmul epilogue (plain torch, as XLA ran it).
- NF4: blockwise 4-bit NormalFloat (bitsandbytes semantics, the `load_4bit`
  captioner), 64 consecutive input elements per absmax block. The canonical
  byte layout is half-row: byte (o, c) of `packed` [out, in/2] holds element
  (o, c) of the [out, in] matrix in its high nibble and (o, c + in/2) in its
  low nibble. `nf4_matmul` sends CUDA tensors to the hand-written kernel
  (`ops/nf4_matmul.py`) and CPU tensors to its plain version.

`quantize_nf4` gives the same bytes as the JAX package: argmin over the 16
codes with the first index on ties, absmax floored at 1e-12.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from .convert import flax_param_path

# flax path substrings kept at their dtype (the reference keeps the
# denoise encoder and the norms out of fp8: fp8 norms destroy quality)
FP8_SKIP = ("denoise_encoder", "norm", "ln_", "scale", "bias")
# ml_dtypes rounds a value of magnitude above 464 (the midpoint between
# 448, e4m3fn's largest finite value, and 480) to NaN, where torch saturates
# to 448; the JAX package's cast is ml_dtypes'
_FP8_NAN_ABOVE = 464.0


def is_fp8_weight(key: str, ndim: int) -> bool:
    """Whether `quantize_params_fp8` casts the UNet state-dict entry `key`:
    the JAX rule, on the lowercased flax path of the entry ("params/" +
    its path joined by "/"), which no substring of FP8_SKIP may be in."""
    name = "/".join(("params",) + flax_param_path(key, ndim)).lower()
    return not any(s in name for s in FP8_SKIP)


def to_fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX factory's two roundings: to the compute `dtype`, then to
    float8_e4m3fn, with ml_dtypes' overflow (NaN above 464, inf and NaN
    included) in place of torch's saturation."""
    x = t.to(dtype)
    x = torch.where(x.abs() <= _FP8_NAN_ABOVE, x, torch.nan)
    return x.to(torch.float8_e4m3fn)


@torch.no_grad()
def quantize_params_fp8(state_dict: Mapping[str, torch.Tensor],
                        dtype: torch.dtype = torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """A UNet state dict with the weights `is_fp8_weight` picks cast by
    `to_fp8`; every other entry as it was."""
    return {k: (to_fp8(v, dtype) if v.is_floating_point()
                and is_fp8_weight(k, v.ndim) else v)
            for k, v in state_dict.items()}


def dequantize_params(state_dict: Mapping[str, torch.Tensor],
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """fp8 entries upcast to `dtype` (exact); the rest as they were."""
    return {k: v.to(dtype) if v.dtype == torch.float8_e4m3fn else v
            for k, v in state_dict.items()}


def param_bytes(state_dict: Mapping[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for v in state_dict.values())


def make_delta(base: Mapping[str, torch.Tensor],
               target: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """target - base per entry, in fp32, cast to target's dtype; an entry
    whose shape changed (embedding rows added by finetuning) is kept as the
    target's."""
    return {k: t if base[k].shape != t.shape
            else (t.float() - base[k].float()).to(t.dtype)
            for k, t in target.items()}


def apply_delta(base: Mapping[str, torch.Tensor],
                delta: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """base + delta per entry, in fp32, cast to delta's dtype."""
    return {k: d if base[k].shape != d.shape
            else (base[k].float() + d.float()).to(d.dtype)
            for k, d in delta.items()}

# the 16 NF4 levels: quantiles of N(0, 1) normalised to [-1, 1]
# (Dettmers et al., "QLoRA", Table A.1 / bitsandbytes functional.py)
NF4_CODE = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], np.float32)

# nibble layouts: 1 = pair-interleaved (bitsandbytes: element 2i high, 2i+1
# low), 2 = half-block (first half of each 64-block high), 3 = half-row
# (canonical). Trees of the three layouts have identical shapes and dtypes,
# so the layout travels with the weight and decode checks it.
NF4_PACK_PAIRWISE = 1
NF4_PACK_HALFBLOCK = 2
NF4_PACK_HALFROW = 3

NF4_BLOCK = 64
# rows of the [out, in] matrix quantised at a time: bounds the fp32
# temporaries to ~64 MB each whatever the matrix size
_QUANT_CHUNK_ELEMS = 1 << 24


class NF4Weight(NamedTuple):
    """Blockwise NF4 matrix. Half-row storage: `packed` uint8 [out, in/2],
    `absmax` f32 [out, in/64]; the legacy layouts keep [n_blocks, 32] /
    [n_blocks]. `shape` is (in, out)."""

    packed: torch.Tensor
    absmax: torch.Tensor
    shape: Tuple[int, int]
    pack_format: int = NF4_PACK_HALFROW


class Int8Weight(NamedTuple):
    """Per-output-channel absmax int8 matrix."""

    values: torch.Tensor    # int8 [in, out]
    scales: torch.Tensor    # f32 [out]


def quantize_int8(w: torch.Tensor) -> Int8Weight:
    """[in, out] float -> int8 with per-column absmax scales."""
    w32 = w.float()
    scales = torch.clamp(w32.abs().amax(dim=0), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scales), -127, 127)
    return Int8Weight(values=q.to(torch.int8), scales=scales)


def int8_matmul(x: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """x [..., in] @ int8 weights in x's dtype: a product of the int8 values
    with an fp32 result, then the per-column scales in fp32."""
    y = torch.matmul(x.float(), w.values.float())
    return (y * w.scales).to(x.dtype)


def _nf4_indices(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, in] fp32 rows -> (code indices uint8 [n, in], absmax [n, in/64]).
    A running minimum with a strict compare is argmin with the first index
    on ties, without a [n, in, 16] temporary."""
    n, in_f = rows.shape
    blocks = rows.reshape(-1, NF4_BLOCK)
    absmax = torch.clamp(blocks.abs().amax(dim=1), min=1e-12)
    normed = blocks / absmax[:, None]
    best = torch.abs(normed - float(NF4_CODE[0]))
    idx = torch.zeros(normed.shape, dtype=torch.uint8, device=rows.device)
    for k in range(1, 16):
        d = torch.abs(normed - float(NF4_CODE[k]))
        better = d < best
        best = torch.where(better, d, best)
        idx.masked_fill_(better, k)
    return idx.reshape(n, in_f), absmax.reshape(n, in_f // NF4_BLOCK)


@torch.no_grad()
def quantize_nf4(w: torch.Tensor) -> NF4Weight:
    """[in, out] float -> blockwise NF4 in the half-row layout, 64 input
    elements of an output channel per block. Rows of the [out, in] matrix
    are quantised in chunks, so a 13824 x 5120 matrix needs no more than a
    few 64 MB temporaries."""
    in_f, out_f = w.shape
    if in_f % NF4_BLOCK:
        raise ValueError(f"quantize_nf4: in={in_f} is not a multiple of {NF4_BLOCK}")
    woi = w.T                                     # [out, in], a view
    packed = torch.empty((out_f, in_f // 2), dtype=torch.uint8, device=w.device)
    absmax = torch.empty((out_f, in_f // NF4_BLOCK), dtype=torch.float32,
                         device=w.device)
    step = max(1, _QUANT_CHUNK_ELEMS // in_f)
    for r in range(0, out_f, step):
        idx, am = _nf4_indices(woi[r:r + step].float().contiguous())
        half = in_f // 2
        packed[r:r + step] = (idx[:, :half] << 4) | idx[:, half:]
        absmax[r:r + step] = am
    return NF4Weight(packed=packed, absmax=absmax, shape=(in_f, out_f))


def _lut(idx: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(NF4_CODE).to(idx.device)[idx.long()]


def _dequant_nf4_oi(q: NF4Weight, dtype=torch.float32) -> torch.Tensor:
    """Decode to the stored [out, in] orientation: code * absmax in fp32,
    then cast to `dtype`. Refuses every layout but half-row."""
    if int(q.pack_format) != NF4_PACK_HALFROW:
        raise ValueError(
            f"NF4Weight pack_format={q.pack_format} is not the half-row "
            f"layout ({NF4_PACK_HALFROW}); repack with repack_nf4")
    in_f, out_f = q.shape
    p = q.packed
    vals = torch.cat([_lut(p >> 4), _lut(p & 0xF)], dim=1)     # [out, in]
    scaled = vals.reshape(-1, NF4_BLOCK) * q.absmax.float().reshape(-1)[:, None]
    return scaled.reshape(out_f, in_f).to(dtype)


def _unpack_idx(q: NF4Weight) -> torch.Tensor:
    """Legacy packed tree ([n_blocks, 32]) -> code indices [out, in] in row
    order."""
    hi, lo = q.packed >> 4, q.packed & 0xF
    in_f, out_f = q.shape
    fmt = int(q.pack_format)
    if fmt == NF4_PACK_PAIRWISE:
        idx = torch.stack([hi, lo], dim=-1).reshape(q.packed.shape[0], -1)
    elif fmt == NF4_PACK_HALFBLOCK:
        idx = torch.cat([hi, lo], dim=1)
    else:
        raise ValueError(f"not a legacy pack_format: {q.pack_format}")
    return idx.reshape(out_f, in_f)


def repack_nf4(q: NF4Weight) -> NF4Weight:
    """One-time conversion of a pair-interleaved or half-block tree to the
    half-row layout, including the [n_blocks, 32] -> [out, in/2] storage
    change."""
    if int(q.pack_format) == NF4_PACK_HALFROW:
        return q
    idx = _unpack_idx(q)
    in_f, out_f = q.shape
    packed = (idx[:, :in_f // 2] << 4) | idx[:, in_f // 2:]
    return NF4Weight(packed=packed.contiguous(),
                     absmax=q.absmax.reshape(out_f, in_f // NF4_BLOCK),
                     shape=q.shape, pack_format=NF4_PACK_HALFROW)


def dequantize_nf4(q: NF4Weight, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense [in, out] matrix."""
    return _dequant_nf4_oi(q, torch.float32).T.to(dtype)


def nf4_matmul(x: torch.Tensor, q: NF4Weight) -> torch.Tensor:
    """Weight-only NF4 matmul in x's dtype, x [..., in] -> [..., out]. A
    CUDA tensor goes to the hand-written kernel, which raises on what it
    does not take (a layout other than half-row, in % 64, a dtype other
    than bf16); a CPU tensor goes to the kernel's plain version."""
    from ..ops.nf4_matmul import nf4_matmul_kernel, nf4_matmul_reference

    if x.device.type == "cpu":
        return nf4_matmul_reference(x, q)
    return nf4_matmul_kernel(x, q)
