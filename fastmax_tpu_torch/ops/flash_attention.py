"""Causal flash attention (counterpart of ``fastmax_tpu/ops/flash_attention.py``):
the KV-cache prefill kernel ``flash_attention`` and, below it, the trainable
entries ``flash_attention_fused`` and ``flash_attention_trainable``.

Prefill (``flash_attention``).

A CUDA tensor goes to the hand-written kernel ``csrc/flash_attention.cu``;
a CPU tensor, or ``plain=True``, goes to ``flash_attention_plain``, which
repeats the kernel's block loop in PyTorch:

  for each block of 128 keys below kv_len and the causal frontier:
    s = (q . k) * scale in f32, masked (j <= pos0 + i and j < kv_len) with -1e30
    m_new = max(m, rowmax s);  p = exp(s - m_new);  alpha = exp(m - m_new)
    l = l * alpha + rowsum p;  acc = acc * alpha + (p rounded to v's dtype) . v
  out = acc / (l == 0 ? 1 : l) in q's dtype

q is (B, Hq, T, D) and k/v the grouped (B, G, S, D) cache layer, never
expanded. A softmax over the whole row would differ from the kernel in
bf16, where p is rounded per block against the running max.

Unlike the JAX caller, which pads T to the 128-row query block, the kernel
and the plain version take any T and compute only the T real rows.

Training (``flash_attention_fused``, ``flash_attention_trainable``). Causal
attention of q, k, v (B, H, T, D), k/v repeated to H, as autograd Functions:
the forward gives out and lse = m + log l (f32), the backward forms
delta = rowsum(do * out) in f32 and then dq, dk, dv. A CUDA tensor goes to
the kernels ``csrc/flash_train_fwd.cu`` (K6) and ``csrc/flash_train_bwd.cu``
(K7), a CPU tensor or ``plain=True`` to ``flash_train_fwd_plain`` /
``flash_train_bwd_plain``, which keep the reference's rounding: p is rounded
to v's type per online-softmax block of keys against that block's running
max (512 keys, or T when T <= 512, for the fused entry; ``block_k`` for the
other), l sums the unrounded p, and the backward rounds p to do's type
before dv and ds to q's/k's type before dk and dq, every sum in f32. The two
entries differ only in that block, so one kernel pair serves both.
"""

from __future__ import annotations

import math

import torch

from ..kernels.build import KERNELS, use_kernel

BLOCK_Q = 128   # the reference's query block: the route pads T to it for eligibility
BLOCK_K = 128   # keys per online-softmax step, in the kernel and the plain version
NEG_INF = -1e30
KERNEL_HEAD_SIZES = (64, 128, 192, 256)  # the head sizes the CUDA kernel is built for


def flash_eligible(t: int, s: int, d: int) -> bool:
    """The reference's conditions: T % 128, S % 128, D % 64 and S >= 2048."""
    return t % BLOCK_Q == 0 and s % BLOCK_K == 0 and d % 64 == 0 and s >= 2048


def _args(q, k, scale, kv_len):
    d, s = q.shape[-1], k.shape[2]
    return (d ** -0.5 if scale is None else float(scale)), (s if kv_len is None else int(kv_len))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale=None, pos0: int = 0, kv_len=None) -> torch.Tensor:
    """q (B, Hq, T, D); k, v (B, G, S, D). Returns (B, Hq, T, D) in q's dtype."""
    b, hq, t, d = q.shape
    g, s = k.shape[1], k.shape[2]
    scale, kv_len = _args(q, k, scale, kv_len)
    pos0 = int(pos0)
    qg = q.reshape(b, g, hq // g, t, d).float()
    qpos = pos0 + torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, g, hq // g, t, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, hq // g, t, d), device=q.device)
    n_blocks = max(0, min(math.ceil(min(kv_len, s) / BLOCK_K), (pos0 + t - 1) // BLOCK_K + 1))
    for jb in range(n_blocks):
        k0 = jb * BLOCK_K
        kb, vb = k[:, :, k0:k0 + BLOCK_K].float(), v[:, :, k0:k0 + BLOCK_K]
        sc = torch.einsum("bgrtd,bgsd->bgrts", qg, kb) * scale
        kpos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        sc = torch.where((kpos <= qpos) & (kpos < kv_len), sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgrts,bgsd->bgrtd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.to(q.dtype).reshape(b, hq, t, d)


def _launch(q, k, v, scale: float, pos0: int, kv_len: int) -> torch.Tensor:
    b, hq, t, d = q.shape
    bb, g, s, dd = k.shape
    if bb != b or dd != d or tuple(v.shape) != tuple(k.shape) or hq % g or t < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_SIZES:
        raise NotImplementedError(f"the flash kernel is built for head sizes "
                                  f"{KERNEL_HEAD_SIZES}, not {d}")
    if not 0 <= kv_len <= s or pos0 < 0:
        raise ValueError(f"pos0 {pos0} and kv_len {kv_len} must lie in [0, S={s}]")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel takes one of "
                        "float32 or bfloat16")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    KERNELS["flash_attention"].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
        b, hq, g, t, s, d, pos0, kv_len, scale)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale=None,
                    pos0: int = 0, kv_len=None, plain: bool = False) -> torch.Tensor:
    """Causal attention of q (B, Hq, T, D) at absolute positions pos0 .. pos0+T-1
    over the first kv_len (default S) keys of k/v (B, G, S, D). pos0 and
    kv_len are Python ints. Returns (B, Hq, T, D) in q's dtype."""
    scale, kv_len = _args(q, k, scale, kv_len)
    if not use_kernel(q, k, v, plain=plain):
        return flash_attention_plain(q, k, v, scale=scale, pos0=pos0, kv_len=kv_len)
    return _launch(q, k, v, scale, int(pos0), kv_len)


# ------------------------------------------------------------------ training

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
MAX_ONLINE_BLOCK = 512  # the largest online-softmax key block K6 takes
PLAIN_BWD_ROWS = 512    # query rows per step of the plain backward (bounds its memory)


def _fused_block(t: int) -> int:
    """The fused entry's block: whole T up to 512, else 512."""
    return t if t <= 512 else 512


def _fused_eligible(t: int, d: int) -> bool:
    """The reference's gate for the fused entry (its TPU VMEM limits), kept so
    the port routes the shapes it routes: T*D <= 4096*64."""
    return t * d <= 4096 * 64 and t * d * 4 * 10 + 8 * 2**20 <= 72 * 2**20


def flash_train_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          block: int):
    """(out (B, H, T, D) in q's dtype, lse (B, H, T) f32): the online softmax
    over key blocks of ``block``, all rows at once (a block past a row is all
    masked, which leaves its m, l and acc as they were)."""
    b, h, t, d = q.shape
    qf = q.float()
    qpos = torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, h, t, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, t, d), device=q.device)
    for k0 in range(0, t, block):
        kb, vb = k[:, :, k0:k0 + block].float(), v[:, :, k0:k0 + block]
        s = torch.einsum("bhtd,bhsd->bhts", qf, kb) * scale
        kpos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_train_bwd_plain(q, k, v, do, lse, delta, scale: float):
    """(dq, dk, dv) in the inputs' dtypes from do, the forward's lse and
    delta = rowsum(do * out) (both (B, H, T) f32), PLAIN_BWD_ROWS query rows
    at a time against the keys at or below them."""
    b, h, t, d = q.shape
    dq = torch.zeros((b, h, t, d), device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for q0 in range(0, t, PLAIN_BWD_ROWS):
        q1 = min(q0 + PLAIN_BWD_ROWS, t)
        qi, doi = q[:, :, q0:q1].float(), do[:, :, q0:q1].float()
        kk, vk = k[:, :, :q1].float(), v[:, :, :q1].float()
        s = torch.einsum("bhid,bhjd->bhij", qi, kk) * scale
        mask = torch.arange(q1, device=q.device)[None, :] <= \
            torch.arange(q0, q1, device=q.device)[:, None]
        p = torch.where(mask, torch.exp(s - lse[:, :, q0:q1, None]), torch.zeros_like(s))
        dp = torch.einsum("bhid,bhjd->bhij", doi, vk)
        ds = p * (dp - delta[:, :, q0:q1, None])
        dv[:, :, :q1] += torch.einsum("bhij,bhid->bhjd", p.to(do.dtype).float(), doi)
        dk[:, :, :q1] += torch.einsum("bhij,bhid->bhjd", ds.to(q.dtype).float(), qi)
        dq[:, :, q0:q1] = torch.einsum("bhij,bhjd->bhid", ds.to(k.dtype).float(), kk)
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def _check_train(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernels take one of "
                        "float32 or bfloat16")
    if q.shape[-1] not in KERNEL_HEAD_SIZES:
        raise NotImplementedError(f"the trainable flash kernels are built for head sizes "
                                  f"{KERNEL_HEAD_SIZES}, not {q.shape[-1]}")


def _train_fwd(q, k, v, scale: float, block: int, plain: bool):
    if not use_kernel(q, k, v, plain=plain):
        return flash_train_fwd_plain(q, k, v, scale, block)
    _check_train(q, k, v)
    if not 1 <= block <= MAX_ONLINE_BLOCK:
        raise NotImplementedError(f"K6 takes online blocks of up to {MAX_ONLINE_BLOCK} keys, "
                                  f"not {block}")
    b, h, t, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    KERNELS["flash_train_fwd"].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), b * h, t, d, block, scale)
    return out, lse


def _train_bwd(q, k, v, do, lse, delta, scale: float, plain: bool):
    if not use_kernel(q, k, v, do, plain=plain):
        return flash_train_bwd_plain(q, k, v, do, lse, delta, scale)
    _check_train(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError(f"do {tuple(do.shape)} {do.dtype} against q {tuple(q.shape)} {q.dtype}")
    b, h, t, d = q.shape
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    KERNELS["flash_train_bwd"].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), b * h, t, d, scale)
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    """out = causal softmax attention; saves (q, k, v, out, lse) for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, block, plain):
        out, lse = _train_fwd(q, k, v, scale, block, plain)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = torch.sum(do.float() * out.float(), dim=-1)
        dq, dk, dv = _train_bwd(q, k, v, do.to(q.dtype), lse, delta, ctx.scale, ctx.plain)
        return dq, dk, dv, None, None, None


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale=None, *,
                          plain: bool = False) -> torch.Tensor:
    """Causal attention of q, k, v (B, H, T, D), k/v repeated to H, with the
    fused entry's online block ``_fused_block(T)``; T a multiple of it (the
    caller pads). Differentiable in q, k, v."""
    t = q.shape[2]
    if t % _fused_block(t):
        raise ValueError(f"T={t} is not a multiple of the fused block {_fused_block(t)}: pad it")
    return _FlashTrain.apply(q, k, v, _scale(q, scale), _fused_block(t), plain)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale=None,
                              block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K, *,
                              plain: bool = False) -> torch.Tensor:
    """As ``flash_attention_fused`` with an online block of ``block_k`` keys; T
    a multiple of block_q and block_k (the caller pads)."""
    t = q.shape[2]
    if t % block_q or t % block_k:
        raise ValueError(f"T={t} is not a multiple of block_q={block_q} and block_k={block_k}")
    return _FlashTrain.apply(q, k, v, _scale(q, scale), block_k, plain)
