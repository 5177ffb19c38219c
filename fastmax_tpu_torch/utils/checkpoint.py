"""Checkpoint I/O: flat name -> tensor state dicts in the reference's on-disk
layouts (counterpart of ``fastmax_tpu/utils/checkpoint.py``).

* The npy directory: ``model/<name>.npy`` ('/' -> '_' in file names) and
  ``model/index.json`` (the sorted names). The HF converter
  (``scripts/convert_hf_checkpoint.py``) and pretraining's ``out_dir/final``
  write it.
* ``lit_model.pth`` / ``.pt`` / ``.bin``: ``torch.save`` of the dict.
* ``.safetensors``, written and read here, not through the ``safetensors``
  package (which the card's machines may lack): an 8-byte little-endian
  header length, a JSON header {name: {"dtype", "shape", "data_offsets":
  [begin, end]}} padded with spaces to a multiple of 8 bytes, then each
  tensor's raw little-endian bytes, back to back in the header's order.

A deploy checkpoint directory holds ``lit_config.json``, the weights in one of
these layouts and the tokenizer files (``check_valid_checkpoint_dir``);
``load_model_params`` reads one into a parameter tree. The torch train state
(``training/fit.py``) is the port's resume format.

Reads are lazy: npy files and a safetensors file's data section are
memory-mapped copy-on-write and ``.pth`` files are read with
``torch.load(mmap=True)``, so a tensor's bytes are read when it is used, and
``models/params.flat_to_params`` moves one tensor at a time to the device.
Writes move one tensor at a time to the host (``.pth`` excepted).

bfloat16 keeps its bits everywhere. numpy has no bfloat16: the JAX package
writes ml_dtypes' bfloat16, a 2-byte void type to numpy (header descr
'<V2'). The port writes the same file for a bfloat16 tensor and reads any
2-byte void ``.npy`` as bfloat16 bits.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
           torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
           torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}
_TORCH_SUFFIXES = (".pth", ".pt", ".bin")


def to_tensor(x) -> torch.Tensor:
    """A torch tensor of ``x`` (a tensor, or a numpy array: bfloat16, as
    ml_dtypes or a 2-byte void, becomes torch.bfloat16 with its bits), without
    a copy where numpy's array is writable."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    bf16 = a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)
    if bf16:
        a = a.view(np.uint16)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def _host(x) -> torch.Tensor:
    return to_tensor(x).contiguous().cpu()


def npy_path(model_dir: Path, name: str) -> Path:
    return model_dir / (name.replace("/", "_") + ".npy")


def write_npy(path: Path, x) -> None:
    """One tensor as a ``.npy`` file; bfloat16 as the JAX package writes it."""
    t = _host(x)
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
        f.write(t.view(torch.int16).numpy())


def read_npy(path: Path) -> torch.Tensor:
    return to_tensor(np.load(path, mmap_mode="c"))


def write_index(model_dir: Path, names) -> None:
    with open(Path(model_dir) / "index.json", "w") as fp:
        json.dump(sorted(names), fp, indent=0)


def _save_safetensors(flat: Dict[str, object], path: Path) -> None:
    header, offset = {}, 0
    for name, x in flat.items():
        t = to_tensor(x)
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((-len(blob)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for x in flat.values():
            f.write(_host(x).reshape(-1).view(torch.uint8).numpy())


def save_flat_checkpoint(flat: Dict[str, object], path: Path) -> None:
    """Save a flat name -> tensor (or numpy array) dict: ``.safetensors``;
    ``.pth``/``.pt``/``.bin`` (``torch.save``); any other path is a directory
    in the npy layout (a path ending in ``.npy`` or ``.npz`` is refused: the
    layout is a directory). Files are written through a temporary name."""
    path = Path(path)
    if path.suffix in (".npy", ".npz"):
        raise NotImplementedError(f"checkpoint format of {path.name!r}: the npy layout is a "
                                  "directory (model/<name>.npy); pass its path")
    if path.suffix not in (".safetensors",) + _TORCH_SUFFIXES:
        model_dir = path / "model"
        model_dir.mkdir(parents=True, exist_ok=True)
        for name, x in flat.items():
            write_npy(npy_path(model_dir, name), x)
        write_index(model_dir, flat)
        return
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    if path.suffix == ".safetensors":
        _save_safetensors(flat, tmp)
    else:
        torch.save({name: _host(x) for name, x in flat.items()}, tmp)
    os.replace(tmp, path)


def _read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = path.stat().st_size - 8 - n
    data = (np.memmap(path, np.uint8, mode="c", offset=8 + n, shape=(size,)) if size > 0
            else np.zeros(0, np.uint8))
    out = {}
    for name, meta in header.items():
        begin, end = meta["data_offsets"]
        if not 0 <= begin <= end <= size:
            raise ValueError(f"{path.name}: {name} lies outside the file")
        dtype = _FROM_NAME[meta["dtype"]]
        if begin == end:
            out[name] = torch.empty(meta["shape"], dtype=dtype)
        else:
            out[name] = torch.from_numpy(data[begin:end]).view(dtype).reshape(meta["shape"])
    return out


def iter_flat_checkpoint(path: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    """Stream (name, tensor) pairs from any supported layout: a directory with
    ``model/index.json``, else with ``lit_model.pth``, else with
    ``model.safetensors``; or a single ``.safetensors`` or
    ``.pth``/``.pt``/``.bin`` file. The tensors are CPU tensors backed by the
    file (see the module's docstring)."""
    path = Path(path)
    if path.is_dir() and (path / "model" / "index.json").is_file():
        model_dir = path / "model"
        with open(model_dir / "index.json") as fp:
            names = json.load(fp)
        for name in names:
            yield name, read_npy(npy_path(model_dir, name))
        return
    if path.is_dir():
        for candidate in ("lit_model.pth", "model.safetensors"):
            if (path / candidate).is_file():
                yield from iter_flat_checkpoint(path / candidate)
                return
        raise FileNotFoundError(f"no weights found under {path}")
    if path.suffix == ".safetensors":
        yield from _read_safetensors(path).items()
        return
    if path.suffix in _TORCH_SUFFIXES:
        yield from torch.load(str(path), map_location="cpu", weights_only=True,
                              mmap=True).items()
        return
    raise ValueError(f"unsupported checkpoint path {path}")


def load_flat_checkpoint(path: Path) -> Dict[str, torch.Tensor]:
    return dict(iter_flat_checkpoint(path))


def load_model_params(checkpoint_dir: Path, cfg=None, dtype=None, device=None):
    """(config, parameter tree) of a checkpoint directory; the config from its
    ``lit_config.json`` unless given, the tree in ``dtype`` (default float32)
    on ``device`` (default: the card)."""
    from ..models.config import Config
    from ..models.params import flat_to_params

    checkpoint_dir = Path(checkpoint_dir)
    if cfg is None:
        cfg = Config.from_checkpoint(checkpoint_dir)
    flat = load_flat_checkpoint(checkpoint_dir)
    return cfg, flat_to_params(flat, cfg, dtype or torch.float32, device)


def check_valid_checkpoint_dir(checkpoint_dir: Path) -> None:
    """Validate the deploy-checkpoint contract (ref lit_gpt/utils.py:44-74)."""
    checkpoint_dir = Path(checkpoint_dir)
    files = {
        "weights": (checkpoint_dir / "model" / "index.json").is_file()
        or (checkpoint_dir / "lit_model.pth").is_file()
        or (checkpoint_dir / "model.safetensors").is_file(),
        "lit_config.json": (checkpoint_dir / "lit_config.json").is_file(),
        "tokenizer": (checkpoint_dir / "tokenizer.json").is_file()
        or (checkpoint_dir / "tokenizer.model").is_file(),
        "tokenizer_config.json": (checkpoint_dir / "tokenizer_config.json").is_file(),
    }
    if all(files.values()):
        return
    missing = [k for k, ok in files.items() if not ok]
    raise OSError(
        f"checkpoint_dir {str(checkpoint_dir)!r} is missing: {missing}. "
        "Convert an HF checkpoint with `python -m fastmax_tpu_torch.scripts.convert_hf_checkpoint` "
        "first."
    )
