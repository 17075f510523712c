"""The port's own safetensors reader and writer.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, offsets relative to the end of the header), then the raw
little-endian tensor bytes.

:func:`read` maps the file copy-on-write and hands out ``torch.frombuffer``
views of it: nothing is copied until a tensor is moved or cast, bf16
included, which is what sdmatte_tpu/runtime/fast_safetensors.py's native
reader gives the JAX package for numpy.  So the port needs neither that
reader nor the ``safetensors`` package.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict

import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header larger than this is not a safetensors file (the format's own cap)
MAX_HEADER_BYTES = 100 << 20


class SafetensorsError(ValueError):
    pass


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data) of a file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", raw)
        if n > MAX_HEADER_BYTES:
            raise SafetensorsError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, each a zero-copy view of a
    private (copy-on-write) mapping of the file, which the tensors keep
    alive."""
    header, start = read_header(path)
    size = os.path.getsize(path)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise SafetensorsError(f"{path}: {name} has unknown dtype {info['dtype']}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or start + end > size:
            raise SafetensorsError(f"{path}: {name} has offsets {begin}..{end} for "
                                   f"{shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                     offset=start + begin).view(shape)
    return out


def write(tensors: Dict[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` (any device; each is copied to the host in turn) in
    the given order, with the ``{"format": "pt"}`` metadata that torch
    exports carry.  The header is padded with spaces to a multiple of 8
    bytes, as the reference writer does, so every tensor's data starts
    8-byte aligned.  Returns the file's size in bytes."""
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise SafetensorsError(f"{name}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)
    return 8 + len(blob) + offset
