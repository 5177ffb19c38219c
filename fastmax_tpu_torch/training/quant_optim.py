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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .step import clip_by_global_norm, f32, tree_leaves

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

    def init(self, params: dict) -> dict:
        m, v = [], []
        for p in tree_leaves(params):
            if not p.is_floating_point():
                m.append(None)
                v.append(None)
            elif p.numel() >= MIN_QUANT_SIZE:
                zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                m.append(quantize_m(zeros, self.block))
                v.append(quantize_v(zeros, self.block))
            else:
                m.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                v.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        return {"count": 0, "m": m, "v": v}

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict) -> None:
        leaves = tree_leaves(params)
        floats = [i for i, p in enumerate(leaves) if p.is_floating_point()]
        clipped = clip_by_global_norm([grads[i] for i in floats], self.max_norm)
        count = state["count"] + 1
        state["count"] = count
        bc1 = 1.0 - f32(self.b1) ** count
        bc2 = 1.0 - f32(self.b2) ** count
        lr = self.schedule(count)
        for i, g in zip(floats, clipped):
            p, ms, vs = leaves[i], state["m"][i], state["v"][i]
            quant = isinstance(ms, dict)
            g32 = g.float()
            m = self.b1 * (dequantize_m(ms, p.shape) if quant else ms) + (1.0 - self.b1) * g32
            v = self.b2 * (dequantize_v(vs, p.shape) if quant else vs) \
                + (1.0 - self.b2) * g32 * g32
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.weight_decay * p.float()
            p.add_((-lr * step).to(p.dtype))
            state["m"][i] = quantize_m(m, self.block) if quant else m
            state["v"][i] = quantize_v(v, self.block) if quant else v


def state_nbytes(state) -> int:
    """The bytes of the persisted optimizer state's tensors."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(state_nbytes(v) for v in state)
    return 0
