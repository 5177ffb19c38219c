"""Flat name -> tensor checkpoints (the ``.safetensors`` and ``.pth`` side of
``fastmax_tpu/utils/checkpoint.py``).

The safetensors format is written and read here, not through the
``safetensors`` package (which the card's machines may lack): an 8-byte
little-endian header length, a JSON header {name: {"dtype", "shape",
"data_offsets": [begin, end]}} padded with spaces to a multiple of 8 bytes,
then each tensor's raw little-endian bytes, back to back in the header's
order. bfloat16 tensors keep their bits. The reference's npy-directory
layout and the lit-format deploy checkpoint are not ported yet.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
           torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
           torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(x))


def save_flat_checkpoint(flat: Dict[str, object], path: Path) -> None:
    """Save a flat name -> tensor (or numpy array) dict as ``.safetensors`` or
    ``.pth``/``.pt``/``.bin`` (``torch.save``), through a temporary file."""
    path = Path(path)
    tensors = {name: _as_tensor(x) for name, x in flat.items()}
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    if path.suffix == ".safetensors":
        header, offset = {}, 0
        for name, t in tensors.items():
            if t.dtype not in _DTYPES:
                raise TypeError(f"{name}: no safetensors dtype for {t.dtype}")
            n = t.numel() * t.element_size()
            header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                            "data_offsets": [offset, offset + n]}
            offset += n
        blob = json.dumps(header, separators=(",", ":")).encode()
        blob += b" " * ((-len(blob)) % 8)
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for t in tensors.values():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif path.suffix in (".pth", ".pt", ".bin"):
        torch.save(tensors, tmp)
    else:
        raise NotImplementedError(f"checkpoint format of {path.name!r}: the port writes "
                                  ".safetensors and .pth (ROADMAP queue A, A7)")
    os.replace(tmp, path)


def load_flat_checkpoint(path: Path) -> Dict[str, torch.Tensor]:
    """Read a file written by ``save_flat_checkpoint`` (or any safetensors
    file) back into CPU tensors."""
    path = Path(path)
    if path.suffix in (".pth", ".pt", ".bin"):
        return torch.load(str(path), map_location="cpu", weights_only=True)
    if path.suffix != ".safetensors":
        raise NotImplementedError(f"checkpoint format of {path.name!r}")
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    header.pop("__metadata__", None)
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, meta in header.items():
        begin, end = meta["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path.name}: {name} lies outside the file")
        dtype = _FROM_NAME[meta["dtype"]]
        if begin == end:
            out[name] = torch.empty(meta["shape"], dtype=dtype)
            continue
        t = torch.frombuffer(bytearray(data[begin:end]), dtype=torch.uint8)
        out[name] = t.view(dtype).reshape(meta["shape"])
    return out
