"""Blockwise causal attention with its own backward (counterpart of
``fastmax_tpu/ops/blockwise_attention.py``, which is XLA in the reference,
not Pallas, and so plain PyTorch here on every device).

The trainable route takes it where the flash kernels do not: head sizes not
divisible by 64, and shapes ``_fused_eligible`` refuses (Llama-2-7B at
T = 4096) when the fused kernel is asked for. Query block i attends the key
prefix ``k[:, :, :(i+1)*block]`` in one step, so no above-diagonal block pair
is formed. As the reference does, p is rounded to v's dtype before the P.V
product and l sums the rounded p; the backward rounds p and ds to q's dtype,
every sum in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

DEFAULT_BLOCK = 512
NEG_INF = -1e30


def _prefix_mask(block: int, kl: int, q0: int, device) -> torch.Tensor:
    """(block, kl) causal mask for query rows q0..q0+block over keys 0..kl."""
    qpos = q0 + torch.arange(block, device=device)[:, None]
    return torch.arange(kl, device=device)[None, :] <= qpos


def _forward(q, k, v, scale: float, block: int):
    """(out, lse) of q, k, v (B, H, T, D), k/v repeated to H; T % block == 0."""
    t = q.shape[2]
    outs, lses = [], []
    for i in range(t // block):
        kl = (i + 1) * block
        s = torch.einsum("bhid,bhjd->bhij", q[:, :, i * block:kl].float(),
                         k[:, :, :kl].float()) * scale
        mask = _prefix_mask(block, kl, i * block, q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m = torch.amax(s, dim=-1)
        p = torch.exp(s - m[..., None]).to(v.dtype)
        l = torch.sum(p, dim=-1, dtype=torch.float32)
        o = torch.einsum("bhij,bhjd->bhid", p.float(), v[:, :, :kl].float())
        outs.append((o / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _backward(q, k, v, out, lse, do, scale: float, block: int):
    t = q.shape[2]
    delta = torch.sum(do.float() * out.float(), dim=-1)
    dqs = []
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i in range(t // block):
        q0, kl = i * block, (i + 1) * block
        qi, doi = q[:, :, q0:kl], do[:, :, q0:kl]
        kk = k[:, :, :kl].float()
        s = torch.einsum("bhid,bhjd->bhij", qi.float(), kk) * scale
        p = torch.where(_prefix_mask(block, kl, q0, q.device),
                        torch.exp(s - lse[:, :, q0:kl, None]), torch.zeros_like(s))
        dp = torch.einsum("bhid,bhjd->bhij", doi.float(), v[:, :, :kl].float())
        ds = (p * (dp - delta[:, :, q0:kl, None])).to(q.dtype).float()
        pc = p.to(q.dtype).float()
        dqs.append(torch.einsum("bhij,bhjd->bhid", ds, kk) * scale)
        dk[:, :, :kl] += torch.einsum("bhij,bhid->bhjd", ds, qi.float()) * scale
        dv[:, :, :kl] += torch.einsum("bhij,bhid->bhjd", pc, doi.float())
    return torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# a custom operator, as the flash entries' forward (ops/flash_attention.py): the
# remat policies "attn" and "dots_attn" keep its (out, lse), the reference's named
# residuals (fastmax_tpu/ops/blockwise_attention.py:95-97)
@torch.library.custom_op(
    "fastmax_tpu_torch::blockwise_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float scale, int block) -> (Tensor, Tensor)")
def blockwise_fwd(q, k, v, scale, block):
    """(out, lse) of q, k, v (B, H, T, D); T % block == 0."""
    return _forward(q, k, v, scale, block)


def _setup(ctx, inputs, output):
    q, k, v, scale, block = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.scale, ctx.block = scale, block


def _backward_op(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    return (*_backward(q, k, v, out, lse, do, ctx.scale, ctx.block), None, None)


blockwise_fwd.register_autograd(_backward_op, setup_context=_setup)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Causal attention, O(T * block) memory, differentiable. q, k, v: (B, H, T, D)
    with k/v repeated to H; T % block == 0 (the caller pads)."""
    t = q.shape[2]
    if t % block:
        raise ValueError(f"T={t} is not a multiple of the block {block}: pad it")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return blockwise_fwd(q, k, v, float(scale), block)[0]
