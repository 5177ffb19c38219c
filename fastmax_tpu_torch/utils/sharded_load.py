"""Host-RAM-bounded checkpoint loading (counterpart of
``fastmax_tpu/utils/sharded_load.py``).

* ``load_sharded_model_params``: each rank of a mesh reads only its own
  slices of every tensor, straight from the file-backed tensors of
  ``utils/checkpoint.load_flat_checkpoint`` (npy files and safetensors data
  are memory-mapped, ``.pth`` files read with ``torch.load(mmap=True)``), so
  no rank ever holds a tensor it does not own, and the weights arrive cut as
  ``parallel/sharding.shard_params`` cuts a whole tree. The reference builds
  global ``jax.Array``s from per-shard callbacks; the port's ranks are
  processes, each with its own local tree.
* ``load_quantized_model_params``: a converted checkpoint streamed into the
  int8 or rank-1 tiled int4 serving tree one layer slice at a time (the
  dense model never exists whole on the host or the device), bit-identical
  to quantizing the whole tree in memory.

A tree of ``LazyLeaf``s (``lazy_model_params``) knows every shape and reads
nothing until a leaf is materialized; ``READ_BYTES`` counts what was read.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# bytes read from checkpoint files by LazyLeaf reads in this process
READ_BYTES = [0]


def _norm(idx: tuple, shape: tuple) -> tuple:
    """idx padded with full slices, each slice with explicit bounds."""
    idx = tuple(idx) + (slice(None),) * (len(shape) - len(idx))
    return tuple(slice(*s.indices(n)[:2]) for s, n in zip(idx, shape))


class LazyLeaf:
    """A tensor that knows its shape and reads an index-slice of itself (a
    tuple of slices) from storage only when asked: the leaf type of the lazy
    parameter tree."""

    __slots__ = ("shape", "_read")

    def __init__(self, shape: Tuple[int, ...], read: Callable):
        self.shape = tuple(shape)
        self._read = read

    def read(self, idx: tuple = ()) -> torch.Tensor:
        return self._read(_norm(idx, self.shape))

    def narrow(self, dim: int, start: int, length: int) -> "LazyLeaf":
        dim = dim % len(self.shape)
        shape = list(self.shape)
        shape[dim] = length

        def read(idx):
            idx = list(idx)
            s = idx[dim]
            idx[dim] = slice(start + s.start, start + s.stop)
            return self._read(tuple(idx))

        return LazyLeaf(tuple(shape), read)

    def zeros(self) -> "LazyLeaf":
        dtype = self.read(tuple(slice(0, 1) for _ in self.shape)).dtype
        return LazyLeaf(self.shape, lambda idx: torch.zeros(
            tuple(s.stop - s.start for s in idx), dtype=dtype))


def _lazy_get(src, transpose: bool = False) -> LazyLeaf:
    """A LazyLeaf over one stored tensor (2-D ones optionally transposed)."""
    shape = tuple(src.shape)

    def take(idx):
        t = src[idx]
        READ_BYTES[0] += t.numel() * t.element_size()
        return t.clone()

    if transpose:
        if len(shape) != 2:
            raise ValueError(f"transpose only supported for 2D, got {shape}")
        return LazyLeaf((shape[1], shape[0]), lambda idx: take((idx[1], idx[0])).T)
    return LazyLeaf(shape, take)


def _lazy_stack(leaves, lead=None) -> LazyLeaf:
    """LazyLeafs stacked on leading axes ``lead`` (default (len(leaves),)),
    row-major, reading only the selected ones."""
    leaves = list(leaves)
    lead = tuple(lead or (len(leaves),))
    nl = len(lead)
    inner = leaves[0].shape

    def read(idx):
        sel = [range(s.start, s.stop) for s in idx[:nl]]
        parts = [leaves[int(np.ravel_multi_index(pos, lead))].read(idx[nl:])
                 for pos in itertools.product(*sel)]
        shape = tuple(len(r) for r in sel) + tuple(s.stop - s.start for s in idx[nl:])
        return torch.stack(parts).reshape(shape)

    return LazyLeaf(lead + tuple(inner), read)


def open_lazy_checkpoint(path: Path) -> dict:
    """name -> file-backed tensor for every tensor of a checkpoint, reading no
    tensor data (``utils/checkpoint.load_flat_checkpoint``: mmap'd npy files
    and safetensors data, ``torch.load(mmap=True)`` for ``.pth``)."""
    from .checkpoint import load_flat_checkpoint

    return load_flat_checkpoint(Path(path))


def lazy_model_params(checkpoint_dir: Path, cfg) -> dict:
    """The model parameter tree with LazyLeaf leaves (nothing read yet)."""
    from ..models.params import flat_to_params

    return flat_to_params(open_lazy_checkpoint(checkpoint_dir), cfg, leaf_get=_lazy_get,
                          leaf_stack=_lazy_stack)


def load_sharded_model_params(checkpoint_dir: Path, mesh, *, cfg=None, dtype=torch.bfloat16,
                              tp: bool = True, device=None):
    """(config, this rank's ``ShardedParams``): every leaf cut by
    ``sharding.shard_params`` on ``mesh`` (over ``model`` unless tp=False,
    and over ``fsdp``), reading only the rank's slices, cast to ``dtype`` on
    ``device`` (default: the rank's card)."""
    from ..models.config import Config
    from ..parallel import collectives as col
    from ..parallel.sharding import shard_params

    checkpoint_dir = Path(checkpoint_dir)
    if cfg is None:
        cfg = Config.from_checkpoint(checkpoint_dir)
    device = col.rank_device(device)
    lazy = lazy_model_params(checkpoint_dir, cfg)

    def materialize(leaf: LazyLeaf) -> torch.Tensor:
        return leaf.read().to(device=device, dtype=dtype).contiguous()

    return cfg, shard_params(lazy, mesh, cfg, tp=tp, materialize=materialize)


def load_quantized_model_params(checkpoint_dir: Path, *, cfg=None, mode: str = "int8",
                                act_dtype=torch.bfloat16, device=None):
    """(config, quantized params): a converted checkpoint streamed straight
    into the int8 or tiled-int4 serving tree, one layer slice of one linear
    on the device at a time.

    mode "int8": per-output-channel symmetric int8 ({"q8", "scale8"});
    mode "int4": tiled int4 with the rank-1 scale envelope ({"q4r1", "u4",
    "v4"}). wte, lm_head, the norms and MoE experts stay dense in
    ``act_dtype`` (the engine's quantization skip rules); a linear's bias too.
    Each layer is quantized by ``ops/quant``'s own functions, so the result
    equals ``quantize_model``/``quantize_int4_tiled`` of the whole tree bit
    for bit."""
    from ..models.config import Config
    from ..ops import quant
    from ..parallel import collectives as col

    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    checkpoint_dir = Path(checkpoint_dir)
    if cfg is None:
        cfg = Config.from_checkpoint(checkpoint_dir)
    device = col.rank_device(device)
    lazy = lazy_model_params(checkpoint_dir, cfg)

    def dense(leaf: LazyLeaf) -> torch.Tensor:
        return leaf.read().to(device=device, dtype=act_dtype).contiguous()

    def quantize(w: torch.Tensor) -> dict:
        w = w.to(device=device, dtype=torch.float32)
        return quant.quantize_int8(w) if mode == "int8" else quant.quantize_int4_tiled(w, "rank1")

    def quantize_leaf(leaf: LazyLeaf) -> dict:
        if len(leaf.shape) == 2:
            return quantize(leaf.read())
        out: dict = {}
        for layer in range(leaf.shape[0]):
            part = quantize(leaf.read((slice(layer, layer + 1),))[0])
            for key, val in part.items():
                if key not in out:
                    out[key] = val.new_empty((leaf.shape[0],) + tuple(val.shape))
                out[key][layer] = val
        return out

    def walk(node, path):
        if isinstance(node, LazyLeaf):
            return dense(node)
        if "kernel" in node and path[0] not in ("lm_head", "wte") and "experts" not in path:
            out = quantize_leaf(node["kernel"])
            if "bias" in node:
                out["bias"] = dense(node["bias"])
            return out
        return {k: walk(v, path + (k,)) for k, v in node.items()}

    return cfg, {k: walk(v, (k,)) for k, v in lazy.items()}
