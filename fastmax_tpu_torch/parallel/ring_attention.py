"""Ring attention: causal softmax attention over a sequence split across the
ranks of a process group (counterpart of
``fastmax_tpu/parallel/ring_attention.py``).

Each rank holds a chunk of N/P positions of q, k and v. The K/V chunks go
round the ring (``collectives.ring_shift``: rank i sends to i + 1) while
each rank folds their contribution into an online-softmax accumulator
(running max, sum of exponentials, weighted values), with the causal mask at
the chunks' global offsets. Plain PyTorch, as the reference leaves this to
XLA; autograd derives the backward, the ring shift's being the reverse
shift (what JAX's transposed ``ppermute`` gives).

    out = ring_attention_local(q, k, v, group)   # on each rank: its chunk
    out = ring_attention_sharded(q, k, v, mesh, axis="model")  # whole in, whole out
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from . import collectives as col

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos0: int, k_pos0: int, scale: float):
    """The online-softmax partials (m, l, acc) of a q chunk against one k/v
    chunk: the rowwise max of the masked scores, the sum of their
    exponentials and the exponential-weighted values. q (B, H, Tq, D), k and v
    (B, H, Tk, D), in float32."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    q_pos = q_pos0 + torch.arange(tq, device=q.device)[:, None]
    k_pos = k_pos0 + torch.arange(tk, device=q.device)[None, :]
    mask = k_pos <= q_pos  # causal on the global positions
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    # rows with no valid key keep m = NEG_INF and add nothing
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhij,bhjd->bhid", p.to(v.dtype), v).float()
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    """Two online-softmax partial triples merged into one."""
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def ring_attention_local(q, k, v, group=None, *, scale: Optional[float] = None):
    """The body each rank of ``group`` runs on its chunks q, k, v (B, H, N/P,
    D); the group rank gives the chunk's global offset. Returns the rank's
    output chunk (B, H, N/P, D) in q's dtype. Differentiable."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p_size = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_group_rank(group, dist.get_rank())
    chunk = q.shape[2]
    q32 = q.float()
    m = torch.full(q32.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    a = torch.zeros_like(q32)
    k_r, v_r = k, v
    for r in range(p_size):
        # the chunk held now came from rank (idx - r) mod P
        src = (idx - r) % p_size
        mb, lb, ab = _block_attend(q32, k_r.float(), v_r.float(), idx * chunk, src * chunk,
                                   scale)
        m, l, a = _merge(m, l, a, mb, lb, ab)
        if r < p_size - 1:  # the last chunk is not passed on
            k_r, v_r = col.ring_shift(k_r, group), col.ring_shift(v_r, group)
    out = a / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, *, axis: str = "model",
                           scale: Optional[float] = None):
    """Whole (B, H, N, D) inputs on every rank of ``mesh``: each rank takes
    its chunk of the sequence over ``axis`` (N must divide by its size), runs
    the ring, and the chunks are gathered: the whole output on every rank."""
    group = mesh.group(axis)
    n = mesh.shape[axis]
    if q.shape[2] % n:
        raise ValueError(f"sequence length {q.shape[2]} must divide over {axis} = {n}")
    i = mesh.coords[axis]
    q, k, v = (x.chunk(n, dim=2)[i] for x in (q, k, v))
    return col.gather_slice(ring_attention_local(q, k, v, group, scale=scale), 2, group)
