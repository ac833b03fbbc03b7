"""NF4 dequant-matmul: ``y = x @ dequant(W)``, W half-row packed NF4.

Counterpart of `faithdiff_tpu/ops/nf4_matmul.py` (`_nf4_matvec_kernel`).
A CUDA tensor goes to the hand-written kernel (`csrc/nf4_matmul.cu`),
which decodes the packed codes in registers / shared memory so the decoded
weight never reaches device memory; a CPU tensor goes to
`nf4_matmul_reference`, the same arithmetic in plain torch.

Arithmetic (the TPU kernel's): each code decodes through the 16-entry
`NF4_CODE` table, is multiplied by its block's absmax in fp32 and rounded
to x's dtype; products are summed in fp32 and the sum is cast to x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.quantize import NF4_BLOCK, NF4_PACK_HALFROW, NF4Weight, _dequant_nf4_oi
from . import _build


def nf4_matmul_reference(x: torch.Tensor, q: NF4Weight) -> torch.Tensor:
    """Plain version: decode and scale in fp32, cast to x's dtype, matmul
    with an fp32 result, cast to x's dtype."""
    w = _dequant_nf4_oi(q, torch.float32).to(x.dtype)        # [out, in]
    return torch.matmul(x.float(), w.float().T).to(x.dtype)


def nf4_matmul_kernel(x: torch.Tensor, q: NF4Weight) -> torch.Tensor:
    """Launch the CUDA kernel on x [..., in] (contiguous bf16 on the card)
    -> bf16 [..., out]. Raises on anything the kernel does not take."""
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
            # packed rows and x halves move as 16-byte vectors
            raise ValueError(f"nf4_matmul_kernel: {name} is not 16-byte aligned")
    lead = x.shape[:-1]
    m = x.numel() // in_f
    out = torch.empty(lead + (out_f,), dtype=torch.bfloat16, device=x.device)
    if m == 0 or out_f == 0:
        return out
    lib = _build.load("nf4_matmul")
    fn = lib.fd_nf4_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), packed.data_ptr(), absmax.data_ptr(),
                  out.data_ptr(), m, in_f, out_f, stream)
    _build.check(lib, code, "nf4_matmul")
    _build.launches["nf4_matmul"] += 1
    return out
