"""Causal flash attention for KV-cache prefill (counterpart of the inference
kernel ``flash_attention`` of ``fastmax_tpu/ops/flash_attention.py``).

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
