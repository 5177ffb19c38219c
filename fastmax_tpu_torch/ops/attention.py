"""Attention algorithms and the ``attn_alg`` dispatch (counterpart of
``fastmax_tpu/ops/attention.py``).

Softmax attention runs on grouped shapes: q (B, Hq, T, D) is viewed as
(B, G, Hq/G, T, D) against un-expanded k/v (B, G, S, D). The dispatch
``attention`` is ported for ``quadratic`` and for ``fastmax``/``fastmax_cuda``
(degree 2, ops/fastmax.py); ``performer`` and ``linearmax`` come in a later
slice.

Quadratic attention at T >= ``BLOCKWISE_MIN_T`` takes the reference's
trainable route (``fastmax_tpu/ops/attention.py:289-347``) with its constants
and ``FASTMAX_TPU_*`` environment names: the KV heads are repeated, then
``FASTMAX_TPU_TRAIN_ATTN`` picks ``flash2`` (the fused entry, padded to its
block), ``flash`` (the split entry, padded to lcm(128, 128)) or
``blockwise``; flash needs a head size divisible by 64 and flash2 also
``_fused_eligible``, else blockwise takes it. The port routes as the reference
does on its chip, flash2 by default, on every device: on the card the flash
entries launch K6/K7, on the CPU they run their plain versions. ``auto`` (the
reference's timing probe) is not ported.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .blockwise_attention import blockwise_attention
from .fastmax import fastmax
from .flash_attention import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, _fused_block, _fused_eligible,
                              flash_attention_fused, flash_attention_trainable)

NEG_INF = float("-inf")

# full-sequence quadratic forwards at T >= this take the trainable route
BLOCKWISE_MIN_T = int(os.environ.get("FASTMAX_TPU_BLOCKWISE_MIN_T", 1024))
# the blockwise query block; 0 sizes it so one (B, H, block, T) f32 transient stays near 512 MB
BLOCKWISE_BLOCK = int(os.environ.get("FASTMAX_TPU_BLOCKWISE_BLOCK", 0))
# the trainable kernel: "flash2" (fused entry), "flash" (split entry) or "blockwise"
TRAIN_ATTN = os.environ.get("FASTMAX_TPU_TRAIN_ATTN", "flash2")


def repeat_kv_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """Expand grouped KV heads (B, G, S, D) -> (B, n_head, S, D)."""
    b, g, s, d = x.shape
    if g == n_head:
        return x
    rep = n_head // g
    return x[:, :, None].expand(b, g, rep, s, d).reshape(b, n_head, s, d)


def softmax_f32(scores: torch.Tensor) -> torch.Tensor:
    """Numerically stable float32 softmax along the last axis; fully masked
    rows (all -inf) give zeros rather than NaN."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    denom = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _grouped_mask(mask, b, hq, g, t, s):
    return torch.broadcast_to(mask, (b, hq, t, s)).reshape(b, g, hq // g, t, s)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Softmax attention with a float32 softmax.

    q: (B, Hq, T, D); k, v: (B, G, S, D) with Hq % G == 0. ``mask`` is a
    boolean tensor broadcastable to (B, Hq, T, S); True = attend. With
    ``is_causal`` and no mask a causal mask is applied. Returns (B, Hq, T, D).
    """
    b, hq, t, d = q.shape
    g, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, g, hq // g, t, d)
    scores = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), k.float()) * scale
    if mask is None and is_causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
    if mask is not None:
        scores = torch.where(_grouped_mask(mask, b, hq, g, t, s), scores, NEG_INF)
    probs = softmax_f32(scores)
    out = torch.einsum("bgrts,bgsd->bgrtd", probs.to(v.dtype), v)
    return out.reshape(b, hq, t, d)


def int8_cache_attention(
    q: torch.Tensor,
    k_codes: torch.Tensor,
    v_codes: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention directly over an int8 KV cache, with the
    per-position scales applied to the scores and probabilities:

      scores[..., s] = (q . k_codes[s]) * k_scale[s]
      out = sum_s (probs[..., s] * v_scale[s]) v_codes[s]

    q: (B, Hq, T, D); k_codes/v_codes: (B, G, S, D) int8; scales (B, G, S).
    """
    b, hq, t, d = q.shape
    g, s = k_codes.shape[1], k_codes.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, g, hq // g, t, d)
    scores = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), k_codes.to(q.dtype).float())
    scores = scores * (scale * k_scale.float())[:, :, None, None, :]
    if mask is not None:
        scores = torch.where(_grouped_mask(mask, b, hq, g, t, s), scores, NEG_INF)
    probs = softmax_f32(scores)
    pv = (probs * v_scale.float()[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bgrts,bgsd->bgrtd", pv.float(), v_codes.float()).to(q.dtype)
    return out.reshape(b, hq, t, d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attn_alg: str,
    head_size: int,
    plain: bool = False,
) -> torch.Tensor:
    """Dispatch on ``attn_alg`` for the causal full-sequence forward (the
    reference's ``mask=None``). q: (B, Hq, T, D); k, v: (B, G, T, D). For the
    linear algorithms the grouped KV heads are repeated to the full head count
    first. An explicit mask and the reference's ``is_decode`` (the linear
    algorithms unmasked over a KV cache) come with the slices that need them."""
    if attn_alg == "quadratic":
        if q.shape[2] >= BLOCKWISE_MIN_T:
            return _long_causal(q, k, v, head_size, plain)
        return scaled_dot_product_attention(q, k, v, scale=1.0 / head_size ** 0.5,
                                            is_causal=True)
    n_head = q.shape[1]
    k = repeat_kv_heads(k, n_head)
    v = repeat_kv_heads(v, n_head)
    if attn_alg in ("fastmax", "fastmax_cuda"):
        return fastmax(q, k, v, p=2, mask=True, plain=plain)
    if attn_alg in ("performer", "linearmax"):
        raise NotImplementedError(f"attn_alg {attn_alg!r} comes with the fastmax linear-cache "
                                  "slice (ROADMAP queue A, item 4)")
    raise ValueError(f"Attention algorithm {attn_alg} not supported")


def _auto_block(b: int, h: int, t: int) -> int:
    limit = 512 * 2**20
    blk = limit // max(b * h * t * 4, 1)
    return int(max(128, min(512, (blk // 128) * 128)))


def _long_causal(q, k, v, head_size: int, plain: bool) -> torch.Tensor:
    """The reference's trainable route for causal quadratic attention at
    T >= BLOCKWISE_MIN_T. Padded tail rows, being causal, never reach a real
    row; they are cut off."""
    if TRAIN_ATTN == "auto":
        raise NotImplementedError(
            "FASTMAX_TPU_TRAIN_ATTN=auto (the reference's timing probe) is not ported yet "
            "(ROADMAP queue A, item 4): set flash2, flash or blockwise")
    b, h, t, _ = q.shape
    scale = 1.0 / head_size ** 0.5
    kf, vf = repeat_kv_heads(k, h), repeat_kv_heads(v, h)
    kern = TRAIN_ATTN
    if kern in ("flash", "flash2") and head_size % 64 == 0:
        if kern == "flash2" and not _fused_eligible(t, head_size):
            kern = "blockwise"
    else:
        kern = "blockwise"
    if kern == "flash2":
        blk = max(_fused_block(t) if t % 512 == 0 or t <= 512 else 512, 128)
    elif kern == "flash":
        blk = math.lcm(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    else:
        blk = BLOCKWISE_BLOCK or _auto_block(b, h, t)
    pad = (-t) % blk
    if pad:
        q, kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, kf, vf))
    if kern == "flash2":
        out = flash_attention_fused(q, kf, vf, scale, plain=plain)
    elif kern == "flash":
        out = flash_attention_trainable(q, kf, vf, scale, plain=plain)
    else:
        out = blockwise_attention(q, kf, vf, scale, blk)
    return out[:, :, :t] if pad else out
