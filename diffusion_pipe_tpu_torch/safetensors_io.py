"""The safetensors format, read and written with json, struct and torch.

A file is an 8-byte little-endian header length N, then N bytes of JSON
header padded with spaces to a multiple of 8, then every tensor's raw
little-endian bytes. The header maps each name to {"dtype", "shape",
"data_offsets": [begin, end]} (offsets into the data after the header) and
may hold "__metadata__", a map of strings. The writer lays tensors out as
the `safetensors` package does (larger dtypes first, then by name), so for
the same tensors and no more than one metadata entry the bytes are the
same; it is the port's own, because the `safetensors` package is not a
dependency of the port.

Arrays from numpy are taken too (numpy has no bf16 nor fp8: those come as
torch tensors); reads give torch tensors on the CPU.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# the safetensors package's Dtype enum order; a file lists its tensors from
# the last of these to the first, then by name
_ENUM_ORDER = ("BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "I16", "U16", "F16", "BF16",
               "I32", "U32", "F32", "F64", "I64", "U64")


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    return value.detach().to("cpu").contiguous()


def save(tensors: Mapping[str, object], metadata: Optional[Mapping[str, str]] = None) -> bytes:
    """The safetensors bytes of `tensors` (torch tensors or numpy arrays)."""
    items = {k: _as_tensor(v) for k, v in tensors.items()}
    order = sorted(items, key=lambda k: (-_ENUM_ORDER.index(_NAMES[items[k].dtype]), k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    chunks = []
    for name in order:
        t = items[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        chunks.append(t.reshape(-1).view(torch.uint8).numpy().tobytes() if nbytes else b"")
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    return struct.pack("<Q", len(text)) + text + b"".join(chunks)


def _header(data) -> Tuple[dict, int]:
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    return json.loads(bytes(data[8:8 + n])), 8 + n


def load(data) -> Dict[str, torch.Tensor]:
    """The tensors of safetensors bytes, as CPU torch tensors (copies)."""
    header, start = _header(data)
    buf = memoryview(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = DTYPES[info["dtype"]]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(bytearray(buf[start + begin:start + end]), dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def metadata(data) -> Dict[str, str]:
    return _header(data)[0].get("__metadata__", {})


def save_file(tensors: Mapping[str, object], path, metadata: Optional[Mapping[str, str]] = None):
    with open(path, "wb") as f:
        f.write(save(tensors, metadata))


def load_file(path) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        return load(f.read())


def read_keys(path) -> list:
    """The tensor names of a safetensors file, from its header alone."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return [k for k in header if k != "__metadata__"]
