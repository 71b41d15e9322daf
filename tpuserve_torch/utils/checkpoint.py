"""Read and write the safetensors format with numpy and torch alone.

A safetensors file is a little-endian u64 header length, a JSON header
({name: {"dtype", "shape", "data_offsets": [begin, end]}} and an optional
"__metadata__"), then the raw bytes of every tensor. The `safetensors`
package is not on every machine the port runs on, so the port reads and
writes the format itself. BF16 crosses as a uint16 view.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_NP = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
       "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "U16": np.uint16,
       "U32": np.uint32, "U64": np.uint64, "BOOL": np.bool_, "BF16": np.int16}
_CODE = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
         torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
         torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, as CPU tensors of its dtype."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n])
    data = memoryview(buf)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        code, shape = meta["dtype"], [int(d) for d in meta["shape"]]
        begin, end = (int(o) for o in meta["data_offsets"])
        if code not in _NP:
            raise ValueError(f"{path}: tensor '{name}' has unsupported dtype {code}")
        arr = np.frombuffer(data[begin:end], dtype=np.dtype(_NP[code]).newbyteorder("<"))
        t = torch.from_numpy(arr.astype(_NP[code]).reshape(shape))
        out[name] = t.view(torch.bfloat16) if code == "BF16" else t
    return out


def write_safetensors(path: str, tensors: Dict[str, object]) -> None:
    """Write numpy arrays or torch tensors (moved to the CPU) as one
    .safetensors file, in name order."""
    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        code = _CODE.get(t.dtype)
        if code is None:
            raise ValueError(f"tensor '{name}': unsupported dtype {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)  # keep the data 8-byte aligned, as the library does
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)) + hb + b"".join(blobs))
