"""Fastmax: degree-p Taylor-polynomial linear attention (counterpart of
``fastmax_tpu/ops/fastmax.py``).

The attention weight is ``f(s) = 1 + s (+ s^2/2 for p=2)`` with
``s = q . k / Z``, rows normalised by ``g_i = sum_j f(s_ij)``. The causal
form runs as a chunked prefix scan (``ops/fastmax_kernels.py``: the CUDA
kernels K4/K5 on the card, their plain walks on the CPU); the unmasked form
is the global-sum formula. q, k, v are (B, H, N, D).

Ported here: ``fastmax`` with the routing the reference takes on its chip
(masked, D <= 64: the fused kernel pair, in the input's type, the chunk
clamped to a multiple of 128 and the tail padded), the unmasked formula,
``_auto_chunk`` and the O(N^2) ``polynomial_attention_reference``. The
masked D > 64 scan, ``linearmax``, ``performer`` and the recurrent decode
state come with the fastmax linear-cache slice (ROADMAP queue A, A5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .fastmax_kernels import MAX_D, fastmax_trainable

DEFAULT_CHUNK = 128


def _auto_chunk(chunk: int, n: int) -> int:
    """Scale the chunk length up for long sequences (fewer state passes),
    capped at 512."""
    return min(max(chunk, n // 8), max(chunk, 512))


def _poly_weights(s, p: int):
    """f(s) = 1 + s (+ s^2/2), elementwise."""
    fs = 1.0 + s
    if p == 2:
        fs = fs + 0.5 * s * s
    return fs


def polynomial_attention_reference(q, k, v, p: int = 1, mask: bool = True,
                                   normalize_term: float | None = None):
    """Quadratic-time reference of fastmax attention."""
    d = q.shape[-1]
    z = normalize_term if normalize_term is not None else 8.0 * math.sqrt(d)
    s = torch.einsum("bhid,bhjd->bhij", q, k) / z
    fs = _poly_weights(s, p)
    if mask:
        n = q.shape[-2]
        causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        fs = torch.where(causal, fs, torch.zeros_like(fs))
    g = torch.sum(fs, dim=-1, keepdim=True)
    return torch.einsum("bhij,bhjd->bhid", fs / g, v)


def _unmasked_linear(q, k, v, z: float, p: int):
    """Global-sum formulation (no causal mask); q may be shorter than k/v, and
    the count term of the denominator is the query length, as in the reference."""
    nq = q.shape[-2]
    f = torch.sum(v, dim=-2, keepdim=True)
    kv = torch.einsum("bhnm,bhnj->bhmj", k, v)
    f = f + torch.einsum("bhim,bhmj->bhij", q, kv) / z
    g = torch.full(q.shape[:-1], float(nq), dtype=q.dtype, device=q.device)
    ksum = torch.sum(k, dim=-2)
    g = g + torch.einsum("bhil,bhl->bhi", q, ksum) / z
    if p == 2:
        b, h, _, d = q.shape
        nk = k.shape[-2]
        kk = torch.einsum("bhnm,bhnl->bhnml", k, k).reshape(b, h, nk, d * d)
        qq = torch.einsum("bhim,bhil->bhiml", q, q).reshape(b, h, nq, d * d)
        kkv = torch.einsum("bhnx,bhnj->bhxj", kk, v)
        f = f + torch.einsum("bhix,bhxj->bhij", qq, kkv) / (2.0 * z * z)
        kksum = torch.sum(kk, dim=-2)
        g = g + torch.einsum("bhix,bhx->bhi", qq, kksum) / (2.0 * z * z)
    return f / g[..., None]


def _masked_kernel(q, k, v, z: float, p: int, chunk: int, plain: bool):
    """The masked path through the kernel pair. The chunk is clamped to a
    multiple of 128 and the sequence padded at its tail only: padded rows
    feed the count normaliser of later chunks, but no real row follows them,
    so no real output changes (the padded rows are sliced off)."""
    n, d = q.shape[-2], q.shape[-1]
    c = min(chunk, max(128, ((n + 127) // 128) * 128))
    c = max(128, (c // 128) * 128)
    n_pad = (-n) % c
    if n_pad:
        q, k, v = (F.pad(x, (0, 0, 0, n_pad)) for x in (q, k, v))
    o = fastmax_trainable(q, k, v, p, z / math.sqrt(d), c, plain=plain)
    return o[:, :, :n, :]


def fastmax(q, k, v, mask: bool = True, normalize_term: float = 8.0,
            tensors_normalized: bool = False, p: int = 1, chunk: int = DEFAULT_CHUNK, *,
            plain: bool = False):
    """Fastmax polynomial linear attention. ``normalize_term`` is multiplied by
    sqrt(D) unless ``tensors_normalized``. The masked path keeps the input's
    type (the kernels round their pair operands to it); the unmasked one runs
    in float32 and casts back. ``plain=True`` sends the kernels' calls to their
    plain PyTorch versions (a test hook)."""
    if p not in (1, 2):
        raise ValueError(f"p should be 1 or 2, got p={p}")
    d = q.shape[-1]
    z = 1.0 if tensors_normalized else float(normalize_term) * math.sqrt(d)
    if mask:
        if d > MAX_D:
            raise NotImplementedError(
                f"masked fastmax at head size {d} > {MAX_D} takes the reference's scan "
                "formulation, which comes with the fastmax linear-cache slice (ROADMAP queue "
                "A, A5)")
        return _masked_kernel(q, k, v, z, p, _auto_chunk(chunk, q.shape[-2]), plain)
    dtype = q.dtype
    o = _unmasked_linear(q.float(), k.float(), v.float(), z, p)
    return o.to(dtype)
