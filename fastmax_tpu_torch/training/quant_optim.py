"""AdamW with blockwise 8-bit moments (counterpart of
``fastmax_tpu/training/quant_optim.py``).

The first moment m persists as int8 with a float32 absmax scale a block of
``BLOCK`` elements; the second moment v as uint8 in square-root space
(q = round(sqrt(v) / scale), read back as (q * scale)^2), which halves v's
dynamic range in log space. A leaf of fewer than ``MIN_QUANT_SIZE``
elements keeps exact float32 moments; an integer leaf (the packed codes of a
quantized base) carries no state and no update. The update is optax's adamw
(bias-corrected moments, m_hat / (sqrt(v_hat) + eps) + wd * p, times the
learning rate) on the moments read back, which are then quantized again: only
the int8/uint8 buffers and their scales live between steps, about 2 + 8 /
``BLOCK`` bytes a parameter against adamw's 8.

As in the reference, the step count is incremented before the schedule reads
it (optax's adamw reads the count before the step), and the bias corrections
are float32.

On a mesh a leaf is a rank's shard, and the blocks stay the whole leaf's:
``BLOCK`` elements of its flat order, ``MIN_QUANT_SIZE`` against its whole
size. Where the shard is a set of whole blocks (each of its contiguous runs
of the whole leaf's flat order is a multiple of ``BLOCK`` long, which also
puts each run's start on a block boundary), the rank holds its own blocks
("local"). Where it is not, every rank holds the whole leaf's blocks
("whole"): it gathers the gradient, updates the whole moments, and applies
its shard of the step. Either way the moments decode to one rank's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .step import clip_by_global_norm, f32, tree_leaves


def _mode(p: torch.Tensor, sp, block: int) -> str:
    """How a leaf's moments are held: "int" (none), "small" (float32, below
    MIN_QUANT_SIZE whole), "local" (the rank's whole blocks), "whole" (the
    whole leaf's blocks on every rank)."""
    if not p.is_floating_point():
        return "int"
    return _float_mode(tuple(p.shape), sp, block)


def _float_mode(shape: tuple, sp, block: int) -> str:
    whole = math.prod(shape) if sp is None else math.prod(sp.whole)
    if whole < MIN_QUANT_SIZE:
        return "small"
    if sp is None or not sp.dims:
        return "local"
    inner = max(sp.dims)
    run = math.prod(shape[inner:])
    return "local" if run % block == 0 and not sp.halves else "whole"


def _block_dims(sp, shape, block: int):
    """(shape, dims) of the per-block scales of a "local" leaf laid out on the
    leaf's dims up to its innermost split dim, whose run holds the blocks."""
    inner = max(sp.dims)
    return (tuple(shape[:inner]) + (math.prod(shape[inner:]) // block,),
            {d: a for d, a in sp.dims.items()})

BLOCK = 256
MIN_QUANT_SIZE = 4096


# ------------------------------------------------------ blockwise codecs


def _to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _from_blocks(b: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return b.reshape(-1)[:n].reshape(shape)


def quantize_m(m: torch.Tensor, block: int = BLOCK) -> dict:
    """Signed absmax int8: q = round(m / (absmax / 127)) a block."""
    fb = _to_blocks(m.float(), block)
    scale = torch.clamp(fb.abs().amax(dim=1, keepdim=True), min=1e-12) / 127.0
    return {"q": torch.round(fb / scale).to(torch.int8), "scale": scale}


def dequantize_m(s: dict, shape) -> torch.Tensor:
    return _from_blocks(s["q"].float() * s["scale"], shape)


def quantize_v(v: torch.Tensor, block: int = BLOCK) -> dict:
    """Unsigned uint8 in square-root space: q = round(sqrt(v) / (max sqrt(v) / 255))."""
    rb = _to_blocks(torch.sqrt(v.float()), block)
    scale = torch.clamp(rb.amax(dim=1, keepdim=True), min=1e-12) / 255.0
    return {"q": torch.round(rb / scale).to(torch.uint8), "scale": scale}


def dequantize_v(s: dict, shape) -> torch.Tensor:
    r = s["q"].float() * s["scale"]
    return _from_blocks(r * r, shape)


# ------------------------------------------------------------- the optimizer


class AdamW8bit:
    """``optax.chain(optax.clip_by_global_norm(max_norm), adamw8bit(schedule,
    b1, b2, eps, weight_decay))`` of the reference. The state is {"count",
    "m", "v"}, one entry a leaf in the order of ``tree_leaves(params)``:
    {"q", "scale"} for a quantized leaf, a float32 tensor for a small one,
    None for an integer one. ``update`` changes the parameters in place."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.02, max_norm: Optional[float] = None,
                 block: int = BLOCK):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_norm, self.block = weight_decay, max_norm, block

    def init(self, params: dict, splits=None) -> dict:
        m, v = [], []
        for i, p in enumerate(tree_leaves(params)):
            sp = None if splits is None else splits[i]
            mode = _mode(p, sp, self.block)
            if mode == "int":
                m.append(None)
                v.append(None)
            elif mode == "small":
                m.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                v.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            else:
                shape = p.shape if mode == "local" else sp.whole
                zeros = torch.zeros(shape, dtype=torch.float32, device=p.device)
                m.append(quantize_m(zeros, self.block))
                v.append(quantize_v(zeros, self.block))
        return {"count": 0, "m": m, "v": v}

    def _each(self, state, splits, fn) -> dict:
        out = dict(state)
        for key in ("m", "v"):
            out[key] = [None if x is None else fn(x, splits[i], isinstance(x, dict))
                        for i, x in enumerate(state[key])]
        return out

    def gather_state(self, state: dict, splits) -> dict:
        """The whole leaves' state (every rank gets it), the codes and scales
        of a "local" leaf's blocks put in the whole leaf's block order."""
        def one(x, sp, quant):
            if not quant or not sp.dims:
                return sp.gather(x)
            local = _shard_shape(sp)
            if _float_mode(local, sp, self.block) == "whole":  # the same on every rank
                return x
            sshape, sdims = _block_dims(sp, local, self.block)
            return {"q": sp.gather(x["q"].reshape(local)).reshape(-1, self.block),
                    "scale": sp.gather(x["scale"].reshape(sshape), sdims).reshape(-1, 1)}
        return self._each(state, splits, one)

    def cut_state(self, state: dict, splits) -> dict:
        """A rank's state from the whole leaves' (``gather_state``'s inverse)."""
        def one(x, sp, quant):
            if not quant or not sp.dims:
                return sp.cut(x)
            if _float_mode(_shard_shape(sp), sp, self.block) == "whole":
                return x
            sshape, sdims = _block_dims(sp, sp.whole, self.block)
            return {"q": sp.cut(x["q"].reshape(sp.whole)).reshape(-1, self.block),
                    "scale": sp.cut(x["scale"].reshape(sshape), sdims).reshape(-1, 1)}
        return self._each(state, splits, one)

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict, splits=None) -> None:
        leaves = tree_leaves(params)
        floats = [i for i, p in enumerate(leaves) if p.is_floating_point()]
        fsplits = None if splits is None else [splits[i] for i in floats]
        clipped = clip_by_global_norm([grads[i] for i in floats], self.max_norm, fsplits)
        count = state["count"] + 1
        state["count"] = count
        bc1 = 1.0 - f32(self.b1) ** count
        bc2 = 1.0 - f32(self.b2) ** count
        lr = self.schedule(count)
        for i, g in zip(floats, clipped):
            p, ms, vs = leaves[i], state["m"][i], state["v"][i]
            sp = None if splits is None else splits[i]
            whole = _mode(p, sp, self.block) == "whole"
            quant = isinstance(ms, dict)
            g32 = (sp.gather(g) if whole else g).float()
            shape = sp.whole if whole else p.shape
            m = self.b1 * (dequantize_m(ms, shape) if quant else ms) + (1.0 - self.b1) * g32
            v = self.b2 * (dequantize_v(vs, shape) if quant else vs) \
                + (1.0 - self.b2) * g32 * g32
            adam = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            step = (sp.cut(adam) if whole else adam) + self.weight_decay * p.float()
            p.add_((-lr * step).to(p.dtype))
            state["m"][i] = quantize_m(m, self.block) if quant else m
            state["v"][i] = quantize_v(v, self.block) if quant else v


def _shard_shape(sp) -> tuple:
    """The shape of a rank's shard of a leaf split as ``sp`` says."""
    shape = list(sp.whole)
    for d, axis in sp.dims.items():
        shape[d] //= sp.mesh.shape[axis]
    return tuple(shape)


def state_nbytes(state) -> int:
    """The bytes of the persisted optimizer state's tensors."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_nbytes(v) for v in state)
    return 0
