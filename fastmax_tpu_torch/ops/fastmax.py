"""Fastmax: degree-p Taylor-polynomial linear attention, and the fork's other
linear arms, linearmax and performer (counterpart of
``fastmax_tpu/ops/fastmax.py``).

The attention weight is ``f(s) = 1 + s (+ s^2/2 for p=2)`` with
``s = q . k / Z``, rows normalised by ``g_i = sum_j f(s_ij)``. q, k, v are
(B, H, N, D).

The causal form has two routes, as the reference has on its chip:

- D <= 64 (``MAX_D``): the fused kernel pair (``ops/fastmax_kernels.py``: the
  CUDA kernels K4/K5 on the card, their plain walks on the CPU), in the
  input's type, the chunk clamped to a multiple of 128 and the tail padded.
- D > 64: the chunked prefix scan in float32 (``_masked_chunked``): each
  chunk of C tokens takes its own C x C block densely and reads a carried
  state of running sums (``cnt``, ``s_v``, ``s_kv``, ``s_k``, and at p = 2
  ``s_kkv`` (D^2, D) and ``s_kk`` (D^2)). Its backward is reversible
  (``_masked_chunked_vjp``, a ``torch.autograd.Function``): the forward keeps
  q, k, v and the final state only, and the backward walks the chunks last
  first, rewinding the state by subtracting each chunk's update. Memory
  stays O(D^3) a head, and ``_masked_grouped`` runs the heads in groups
  (``_auto_head_groups``) so that one group's p = 2 state stays near
  ``FASTMAX_TPU_HEADGROUP_LIMIT`` bytes. The reference has no Pallas kernel
  on this route, and neither has the port: it is plain PyTorch on the card.

``linearmax`` (the hack's mean-centred, max-norm-scaled q and k at Z = 1) and
``performer`` (causal dot-product attention with a sign-keeping denominator
clamp) run the scan's idea with autograd through the chunk loop, as the
reference differentiates them; neither takes the fastmax kernels. The
unmasked form is the global-sum formula.

The recurrent decode state (the serving path's O(1) cache, counterpart of
the reference's ``fastmax_prefill_state`` .. ``linear_attn_decode_step``):
a prefill runs the scan over the prompt and keeps its final state (at every
head size: it never takes the kernel pair), and each decode step absorbs the
new (k, v) into the state, then reads it with the new q. A step updates
the state in place (where the reference returns a new one, its buffers
donated): the outer products are added by ``baddbmm_`` without being
materialised, which spares the p = 2 state's (D^2, D) a copy. Plain
PyTorch, as the reference is plain XLA here.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from .fastmax_kernels import MAX_D, fastmax_trainable

DEFAULT_CHUNK = 128

# performer's denominator conditioning, under the reference's names and
# environment variables: |den| is floored, its sign kept, at rel * |q| *
# |cumsum k + eps| and at least DEN_FLOOR; the output is clipped to
# +-OUT_CLIP (see ``performer``)
DEN_REL_FLOOR = float(os.environ.get("FASTMAX_TPU_PERFORMER_DEN_REL", 0.05))
DEN_FLOOR = float(os.environ.get("FASTMAX_TPU_PERFORMER_DEN_FLOOR", 1e-2))
OUT_CLIP = float(os.environ.get("FASTMAX_TPU_PERFORMER_OUT_CLIP", 64.0))

# the scan state's entries, in order; p = 1 carries the first four
STATE_NAMES = ("cnt", "s_v", "s_kv", "s_k", "s_kkv", "s_kk")


def _clamp_den(den, floor):
    """|den| floored at ``floor``, its sign kept (0 counts as positive)."""
    sign = torch.where(den >= 0.0, 1.0, -1.0)
    return sign * torch.maximum(den.abs(), floor)


def _wide(x):
    """float32, or float64 for a float64 input (a yardstick for the float32 path)."""
    return x if x.dtype == torch.float64 else x.float()


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


# ---------------------------------------------------------------- the chunked scan
# The scan works on (G, N, D) tensors, G = B * H, with N padded at its tail to
# a whole number of chunks. Zero tokens add nothing to the state but a count.


def _fold(x, n_pad: int):
    """(B, H, N, D) -> (B * H, N + n_pad, D), zeros at the tail."""
    b, h, n, d = x.shape
    x = x.reshape(b * h, n, d)
    return F.pad(x, (0, 0, 0, n_pad)) if n_pad else x


def _outer(x):
    """Row-wise x (x) x: (G, C, D) -> (G, C, D^2), entry (m, l) at m D + l."""
    g, c, d = x.shape
    return torch.einsum("gcm,gcl->gcml", x, x).reshape(g, c, d * d)


def _state_zeros(x, d: int, p: int) -> tuple:
    """The empty state of x's G heads, in x's type (float32 on every route;
    float64 for a yardstick)."""
    g = x.shape[0]
    shapes = ((g,), (g, d), (g, d, d), (g, d)) + (((g, d * d, d), (g, d * d)) if p == 2 else ())
    return tuple(x.new_zeros(s) for s in shapes)


def _chunk_forward(qi, ki, vi, state, z: float, p: int, causal):
    """One chunk's output, from its own C x C block and the state of every
    chunk before it. qi, ki, vi: (G, C, D)."""
    cnt, s_v, s_kv, s_k = state[:4]
    s = qi @ ki.transpose(1, 2) / z
    fs = torch.where(causal, _poly_weights(s, p), 0.0)
    f = fs @ vi + s_v[:, None] + qi @ s_kv / z
    g = fs.sum(-1) + cnt[:, None] + (qi @ s_k[..., None])[..., 0] / z
    if p == 2:
        # (q (x) q) s_kkv as q_l (q_m s_kkv[m, l, :]): the D^2-wide product has
        # D^2 columns and depth D, not depth D^2; likewise (q (x) q) . s_kk
        s_kkv, s_kk = state[4:]
        gs, c, d = qi.shape
        qs = (qi @ s_kkv.view(gs, d, d * d)).view(gs, c, d, d)
        f = f + torch.einsum("gcl,gclj->gcj", qi, qs) / (2.0 * z * z)
        g = g + ((qi @ s_kk.view(gs, d, d)) * qi).sum(-1) / (2.0 * z * z)
    return f / g[..., None]


def _chunk_update(ki, vi, p: int) -> tuple:
    """What one chunk adds to the state."""
    g, c, d = ki.shape
    kt = ki.transpose(1, 2)
    upd = (ki.new_full((g,), float(c)), vi.sum(1), kt @ vi, ki.sum(1))
    if p == 2:
        upd += (_outer(ki).transpose(1, 2) @ vi, (kt @ ki).reshape(g, d * d))
    return upd


def _state_add(a: tuple, b: tuple, sign: float) -> tuple:
    return tuple(torch.add(x, y, alpha=sign) for x, y in zip(a, b))


def _causal(c: int, device):
    return torch.ones((c, c), dtype=torch.bool, device=device).tril()


def _masked_chunked(q, k, v, z: float, p: int, chunk: int, return_state: bool = False):
    """Causal chunked prefix scan; differentiable by autograd, which keeps
    every chunk's state (``_masked_chunked_vjp`` does not). With
    ``return_state`` also the final state, a dict of ``STATE_NAMES``
    entries of shape (B, H, ...), counting real tokens only."""
    b, h, n, d = q.shape
    c = min(chunk, n)
    n_pad = (-n) % c
    qf, kf, vf = (_fold(x, n_pad) for x in (q, k, v))
    causal = _causal(c, q.device)
    state = _state_zeros(qf, d, p)
    outs = []
    for i in range(0, n + n_pad, c):
        qi, ki, vi = (x[:, i:i + c] for x in (qf, kf, vf))
        outs.append(_chunk_forward(qi, ki, vi, state, z, p, causal))
        state = _state_add(state, _chunk_update(ki, vi, p), 1.0)
    o = torch.cat(outs, dim=1)[:, :n].reshape(b, h, n, d)
    if not return_state:
        return o
    # the padded tail's zero tokens add only to cnt
    state = (state[0] - float(n_pad),) + state[1:]
    return o, {name: x.reshape(b, h, *x.shape[1:]) for name, x in zip(STATE_NAMES, state)}


class _MaskedChunkedVJP(torch.autograd.Function):
    """``_masked_chunked`` with the reversible backward. The state update is
    additive, so the state before a chunk is the state after it less the
    chunk's update: the backward walks the chunks last first from the final
    state, rewinding it, and takes each chunk's VJP by re-running its forward
    on detached leaves under autograd. It keeps q, k, v and one state,
    O(D^3) a head, where autograd through the scan keeps one a chunk."""

    @staticmethod
    def forward(ctx, q, k, v, z: float, p: int, chunk: int):
        o, state = _masked_chunked(q, k, v, z, p, chunk, return_state=True)
        ctx.save_for_backward(q, k, v, *(state[name] for name in STATE_NAMES[:len(state)]))
        ctx.z, ctx.p, ctx.chunk = z, p, chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *final = ctx.saved_tensors
        z, p = ctx.z, ctx.p
        b, h, n, d = q.shape
        c = min(ctx.chunk, n)
        n_pad = (-n) % c
        qf, kf, vf, dof = (_fold(x, n_pad) for x in (q, k, v, do))
        state = tuple(x.reshape(b * h, *x.shape[2:]) for x in final)
        # walk the same states as the forward: its padded tokens counted
        state = (state[0] + float(n_pad),) + state[1:]
        d_state = tuple(torch.zeros_like(x) for x in state)
        causal = _causal(c, q.device)
        dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
        for i in reversed(range(0, n + n_pad, c)):
            qi, ki, vi, doi = (x[:, i:i + c] for x in (qf, kf, vf, dof))
            with torch.enable_grad():
                kl, vl = ki.detach().requires_grad_(), vi.detach().requires_grad_()
                upd = _chunk_update(kl, vl, p)
                state = _state_add(state, tuple(u.detach() for u in upd), -1.0)
                leaves = tuple(x.detach().requires_grad_() for x in (qi, ki, vi) + state)
                o = _chunk_forward(*leaves[:3], leaves[3:], z, p, causal)
                grads = torch.autograd.grad(o, leaves, doi)
                # the update's VJP against the cotangent of the state after this
                # chunk (cnt's update is a constant)
                dk_u, dv_u = torch.autograd.grad(upd[1:], (kl, vl), d_state[1:])
            dq[:, i:i + c] = grads[0]
            dk[:, i:i + c] = grads[1] + dk_u
            dv[:, i:i + c] = grads[2] + dv_u
            d_state = _state_add(d_state, grads[3:], 1.0)

        def unfold(x):
            return x[:, :n].reshape(b, h, n, d)

        return unfold(dq), unfold(dk), unfold(dv), None, None, None


def _masked_chunked_vjp(q, k, v, z: float, p: int, chunk: int):
    return _MaskedChunkedVJP.apply(q, k, v, z, p, chunk)


def _auto_head_groups(b: int, h: int, d: int, p: int, limit_bytes: int | None = None) -> int:
    """The number of head groups (a divisor of h) that keeps one group's p = 2
    scan state, b * h * d^3 float32 over the groups, near ``limit_bytes``
    (default ``FASTMAX_TPU_HEADGROUP_LIMIT``, 64 MiB). The heads are
    independent, so grouping changes no value."""
    if limit_bytes is None:
        limit_bytes = int(os.environ.get("FASTMAX_TPU_HEADGROUP_LIMIT", 64 * 2**20))
    if p != 2:
        return 1
    state_bytes = b * h * d * d * d * 4
    if state_bytes <= limit_bytes:
        return 1
    groups = min(h, -(-state_bytes // limit_bytes))
    while h % groups:
        groups += 1
    return groups


def _masked_grouped(q, k, v, z: float, p: int, chunk: int, head_group):
    """The reversible scan over groups of heads, one group after another."""
    b, h, n, d = q.shape
    groups = head_group if head_group else _auto_head_groups(b, h, d, p)
    if groups <= 1:
        return _masked_chunked_vjp(q, k, v, z, p, chunk)
    if h % groups:
        raise ValueError(f"head_group {groups} must divide n_head {h}")
    hg = h // groups
    return torch.cat([_masked_chunked_vjp(qg, kg, vg, z, p, chunk)
                      for qg, kg, vg in zip(q.split(hg, 1), k.split(hg, 1), v.split(hg, 1))],
                     dim=1)


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
            tensors_normalized: bool = False, p: int = 1, chunk: int = DEFAULT_CHUNK,
            head_group: int | None = None, *, plain: bool = False):
    """Fastmax polynomial linear attention. ``normalize_term`` is multiplied by
    sqrt(D) unless ``tensors_normalized``. Masked at D <= 64 it takes the
    kernel pair in the input's type; masked at D > 64 the reversible scan in
    float32 over ``head_group`` groups of heads (None: ``_auto_head_groups``;
    it does not touch the kernel route); unmasked the global-sum formula in
    float32. The float32 routes cast back to the input's type. ``plain=True``
    sends the kernels' calls to their plain PyTorch versions (a test hook)."""
    if p not in (1, 2):
        raise ValueError(f"p should be 1 or 2, got p={p}")
    d = q.shape[-1]
    z = 1.0 if tensors_normalized else float(normalize_term) * math.sqrt(d)
    if mask and d <= MAX_D:
        return _masked_kernel(q, k, v, z, p, _auto_chunk(chunk, q.shape[-2]), plain)
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    if mask:
        o = _masked_grouped(q, k, v, z, p, _auto_chunk(chunk, q.shape[-2]), head_group)
    else:
        o = _unmasked_linear(q, k, v, z, p)
    return o.to(dtype)


# ---------------------------------------------------------------- linearmax, performer


def _hack_normalize(q, k):
    """Mean-centre the channels, then divide by the largest token norm of each
    (B, H)."""
    q = q - q.mean(-1, keepdim=True)
    k = k - k.mean(-1, keepdim=True)
    qn = torch.sqrt(torch.sum(q * q, dim=-1))
    kn = torch.sqrt(torch.sum(k * k, dim=-1))
    return q / qn.amax(-1)[..., None, None], k / kn.amax(-1)[..., None, None]


def linearmax(q, k, v, p: int = 1, mask: bool = True, chunk: int = DEFAULT_CHUNK):
    """The reference's linearmax (its ``fastmax_hack``): q and k through
    ``_hack_normalize``, then degree-p polynomial attention at Z = 1, in
    float32, cast back. Masked it runs ``_masked_chunked`` with autograd
    through the chunks, at every head size."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    q, k = _hack_normalize(q, k)
    if mask:
        o = _masked_chunked(q, k, v, 1.0, p, _auto_chunk(chunk, q.shape[-2]))
    else:
        o = _unmasked_linear(q, k, v, 1.0, p)
    return o.to(dtype)


def performer(q, k, v, eps: float = 1e-6, chunk: int = DEFAULT_CHUNK,
              den_floor: float = DEN_FLOOR):
    """Causal dot-product linear attention, the reference's ``performer``
    branch: o_i = sum_{j<=i} (q_i . k_j) v_j / (q_i . (cumsum(k)_i + eps)), by
    chunks carrying sum k (x) v and sum k, in float32 (``_wide``), cast back. The
    denominator crosses zero for real activations, so its magnitude is
    floored at max(DEN_REL_FLOOR |q_i| |cumsum(k)_i + eps|, den_floor), its
    sign kept, and the output clipped to +-OUT_CLIP (zero gradient outside);
    on well-conditioned rows neither acts."""
    dtype = q.dtype
    q, k, v = _wide(q), _wide(k), _wide(v)
    b, h, n, d = q.shape
    c = min(chunk, n)
    n_pad = (-n) % c
    qf, kf, vf = (_fold(x, n_pad) for x in (q, k, v))
    causal = _causal(c, q.device)
    s_kv = qf.new_zeros((b * h, d, d))
    s_k = qf.new_zeros((b * h, d))
    outs = []
    for i in range(0, n + n_pad, c):
        qi, ki, vi = (x[:, i:i + c] for x in (qf, kf, vf))
        num = torch.where(causal, qi @ ki.transpose(1, 2), 0.0) @ vi + qi @ s_kv
        k_cum = s_k[:, None] + ki.cumsum(1) + eps
        den = torch.sum(qi * k_cum, dim=-1)
        qn = torch.sqrt(torch.sum(qi * qi, dim=-1))
        kn = torch.sqrt(torch.sum(k_cum * k_cum, dim=-1))
        floor = torch.clamp(DEN_REL_FLOOR * qn * kn, min=den_floor)
        outs.append(torch.clamp(num / _clamp_den(den, floor)[..., None], -OUT_CLIP, OUT_CLIP))
        s_kv = s_kv + ki.transpose(1, 2) @ vi
        s_k = s_k + ki.sum(1)
    o = torch.cat(outs, dim=1)[:, :n].reshape(b, h, n, d)
    return o.to(dtype)


# ---------------------------------------------------------------- the decode state
# A prompt's running state, then one token at a time (the serving path). The
# state is a dict of STATE_NAMES entries of shape (B, H, ...) in float32;
# linearmax adds the prompt's frozen normalisers q_div, k_div (B, H). Inputs in
# float64 stay in float64 (``_wide``). A decode step updates the state's
# tensors in place and returns the same dict.


def _add_outer_(s, a, b):
    """s (..., M, N) += a (..., M) (x) b (..., N), in place, by a batched
    product of depth 1 (``baddbmm_``: the outer products are not materialised)."""
    m, n = s.shape[-2:]
    s.view(-1, m, n).baddbmm_(a.reshape(-1, m, 1), b.reshape(-1, 1, n))
    return s


def _read(x, s):
    """x (B, H, M) . s (B, H, M, N) -> (B, H, N)."""
    return (x.unsqueeze(-2) @ s).squeeze(-2)


def fastmax_prefill_state(q, k, v, *, p: int, normalize_term: float = 8.0,
                          tensors_normalized: bool = False, chunk: int = DEFAULT_CHUNK):
    """Masked fastmax over a prompt through the scan in float32 (at every head
    size), returning (output in q's type, the final state)."""
    dtype = q.dtype
    q, k, v = _wide(q), _wide(k), _wide(v)
    d = q.shape[-1]
    z = 1.0 if tensors_normalized else float(normalize_term) * math.sqrt(d)
    o, state = _masked_chunked(q, k, v, z, p, chunk, return_state=True)
    return o.to(dtype), state


def linearmax_prefill_state(q, k, v, *, p: int = 1, chunk: int = DEFAULT_CHUNK):
    """linearmax over a prompt, with its state. The normalisers (the largest
    token norm of the whole sequence, an acausal statistic) are measured on
    the prompt and frozen in the state as q_div, k_div (floored at 1e-6):
    decode keeps dividing by them, and the prompt's output is linearmax's."""
    dtype = q.dtype
    q, k, v = _wide(q), _wide(k), _wide(v)
    q = q - q.mean(-1, keepdim=True)
    k = k - k.mean(-1, keepdim=True)
    q_div = torch.sqrt(torch.sum(q * q, dim=-1)).amax(-1).clamp_min(1e-6)  # (B, H)
    k_div = torch.sqrt(torch.sum(k * k, dim=-1)).amax(-1).clamp_min(1e-6)
    o, state = _masked_chunked(q / q_div[..., None, None], k / k_div[..., None, None], v,
                               1.0, p, chunk, return_state=True)
    state["q_div"], state["k_div"] = q_div, k_div
    return o.to(dtype), state


def linear_attn_state_init(batch: int, heads: int, d: int, p: int, device=None) -> dict:
    """The empty state in float32; at p = 1 the two p = 2 entries are
    placeholders that no step reads."""
    d2 = d * d if p == 2 else 1
    shapes = {"cnt": (batch, heads), "s_v": (batch, heads, d), "s_kv": (batch, heads, d, d),
              "s_k": (batch, heads, d), "s_kkv": (batch, heads, d2, d), "s_kk": (batch, heads, d2)}
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name, shape in shapes.items()}


def linear_attn_decode_step(state, q, k, v, z: float, p: int):
    """One causal step: absorb (k, v) into the state first (the token attends
    to itself), then emit the output for q, the masked fastmax formula at
    position cnt. q, k, v: (B, H, D). Returns (state, o (B, H, D) float32)."""
    b, h, d = q.shape
    q, k, v = _wide(q), _wide(k), _wide(v)
    cnt = state["cnt"].add_(1.0)
    s_v = state["s_v"].add_(v)
    s_kv = _add_outer_(state["s_kv"], k, v)
    s_k = state["s_k"].add_(k)
    f = s_v + _read(q, s_kv) / z
    g = cnt + torch.sum(q * s_k, dim=-1) / z
    if p == 2:
        kk = (k[..., :, None] * k[..., None, :]).reshape(b, h, d * d)
        qq = (q[..., :, None] * q[..., None, :]).reshape(b, h, d * d)
        s_kkv = _add_outer_(state["s_kkv"], kk, v)
        s_kk = state["s_kk"].add_(kk)
        f = f + _read(qq, s_kkv) / (2.0 * z * z)
        g = g + torch.sum(qq * s_kk, dim=-1) / (2.0 * z * z)
    return state, f / g[..., None]


def linearmax_decode_step(state, q, k, v, p: int = 1):
    """One linearmax step with the prompt's frozen normalisers."""
    q, k = _wide(q), _wide(k)
    q = (q - q.mean(-1, keepdim=True)) / state["q_div"][..., None]
    k = (k - k.mean(-1, keepdim=True)) / state["k_div"][..., None]
    return linear_attn_decode_step(state, q, k, v, 1.0, p)


def performer_prefill_state(q, k, v, eps: float = 1e-6, chunk: int = DEFAULT_CHUNK):
    """Causal performer over a prompt, with the state s_kv = sum k (x) v and
    s_k = sum k over the whole of k, v."""
    o = performer(q, k, v, eps=eps, chunk=chunk)
    k32, v32 = _wide(k), _wide(v)
    state = {"s_kv": torch.einsum("bhnm,bhnj->bhmj", k32, v32), "s_k": k32.sum(-2)}
    return o.to(q.dtype), state


def performer_decode_step(state, q, k, v, eps: float = 1e-6, den_floor: float = DEN_FLOOR):
    """One performer step: absorb (k, v), then q's numerator over its
    denominator with ``performer``'s sign-keeping floor and output clip."""
    q, k, v = _wide(q), _wide(k), _wide(v)
    s_kv = _add_outer_(state["s_kv"], k, v)
    s_k = state["s_k"].add_(k)
    num = _read(q, s_kv)
    den = torch.sum(q * (s_k + eps), dim=-1)
    qn = torch.sqrt(torch.sum(q * q, dim=-1))
    kn = torch.sqrt(torch.sum((s_k + eps) ** 2, dim=-1))
    floor = torch.clamp(DEN_REL_FLOOR * qn * kn, min=den_floor)
    return state, torch.clamp(num / _clamp_den(den, floor)[..., None], -OUT_CLIP, OUT_CLIP)
