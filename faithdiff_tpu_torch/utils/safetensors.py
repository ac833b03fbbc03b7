"""Reader and writer of the safetensors format, on numpy and torch alone.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the raw tensor buffers. The JSON maps each tensor name to
`{"dtype": "F32", "shape": [...], "data_offsets": [begin, end]}` (offsets
into the buffers, which follow the header with no gap) and may hold a
`"__metadata__"` map of strings. Tensors are little-endian and C-ordered.

`load_file` maps the file into memory (`np.memmap`, copy-on-write) and
returns tensors that are views of the map, so a 5 GB UNet file is read
from the page cache as its tensors are used and is not held twice. numpy
has no bfloat16: BF16 buffers are read as int16 and viewed as
`torch.bfloat16`.
"""
from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors dtype name -> (numpy dtype of the buffer, torch dtype)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "U8": (np.uint8, torch.uint8),
}
_NAMES = {torch_dtype: name for name, (_, torch_dtype) in _DTYPES.items()}
# the reference implementation refuses headers past 100 MB
_MAX_HEADER = 100 * 1000 * 1000


def _header(buf: np.ndarray, path: str) -> Tuple[dict, int]:
    """(parsed JSON header, offset of the first buffer byte)."""
    if buf.size < 8:
        raise ValueError(f"{path}: not a safetensors file (under 8 bytes)")
    (n,) = struct.unpack("<Q", buf[:8].tobytes())
    if n > _MAX_HEADER or 8 + n > buf.size:
        raise ValueError(f"{path}: header length {n} past the file "
                         f"({buf.size} bytes)")
    try:
        header = json.loads(buf[8:8 + n].tobytes().decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    return header, 8 + n


def read_metadata(path: str) -> Dict[str, str]:
    """The file's `__metadata__` map ({} when it has none)."""
    header, _ = _header(np.memmap(path, dtype=np.uint8, mode="r"), path)
    return dict(header.get("__metadata__") or {})


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, as CPU tensors backed by a memory map of
    it. Raises ValueError on a malformed file: an unknown dtype, a size
    that disagrees with the shape, or buffers that do not tile the data
    region exactly."""
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    header, start = _header(buf, path)
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: tuple(kv[1].get("data_offsets", (0, 0))))
    out: Dict[str, torch.Tensor] = {}
    end_prev = 0
    for name, info in entries:
        dtype = info.get("dtype")
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}; "
                             f"read are {sorted(_DTYPES)}")
        np_dtype, torch_dtype = _DTYPES[dtype]
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(np_dtype).itemsize
        if begin != end_prev or end - begin != nbytes or start + end > buf.size:
            raise ValueError(f"{path}: tensor {name!r} at [{begin}, {end}) "
                             f"does not fit {dtype} {list(shape)} after byte "
                             f"{end_prev}")
        end_prev = end
        arr = buf[start + begin:start + end]
        if (start + begin) % np.dtype(np_dtype).itemsize:
            arr = arr.copy()            # unaligned: torch wants aligned data
        t = torch.from_numpy(arr.view(np_dtype).reshape(shape))
        out[name] = t.view(torch.bfloat16) if dtype == "BF16" else t
    if start + end_prev != buf.size:
        raise ValueError(f"{path}: {buf.size - start - end_prev} bytes past "
                         "the last tensor")
    return out


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` file of a directory, merged in sorted order."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(load_file(f))
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device; copied to the host one at a time) as a
    safetensors file. Buffers are ordered by element size, largest first,
    then by name, so every buffer starts aligned to its element size; the
    header is padded with spaces to a multiple of 8 bytes."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise TypeError(f"save_file: {name!r} is {t.dtype}; written are "
                            f"{sorted(_NAMES.values())}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().reshape(-1).view(np.uint8).data)
