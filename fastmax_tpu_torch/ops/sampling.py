"""Token sampling: temperature and top-k by the Gumbel-max trick
(counterpart of ``fastmax_tpu/ops/sampling.py``).

The noise comes from an explicit ``torch.Generator`` where the reference
takes a ``jax.random`` key. The two give different bits from one seed, so
tests compare distributions. ``speculative_accept*`` comes with the
speculative-decoding slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def _gumbel(shape, device, generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -min(top_k, logits.shape[-1])][..., None]
    return torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)


def sample(logits: torch.Tensor, temperature: float = 0.0, top_k: Optional[int] = None, *,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Token ids (int32) from (..., vocab) logits. temperature <= 0 is the
    float32 argmax; otherwise the top_k most likely tokens (all with None)
    are sampled at that temperature."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k is not None:
        logits = _top_k_filter(logits, top_k)
    logits = logits / temperature
    noise = _gumbel(logits.shape, logits.device, generator)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def filtered_log_probs(logits: torch.Tensor, temperature: float,
                       top_k: Optional[int] = None) -> torch.Tensor:
    """Log-probabilities of the distribution ``sample`` draws from (top-k
    filter, then a temperature-scaled softmax). temperature must be > 0."""
    logits = logits.float()
    if top_k is not None:
        logits = _top_k_filter(logits, top_k)
    return torch.log_softmax(logits / temperature, dim=-1)


def sample_traced(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None, hot: bool = True) -> torch.Tensor:
    """Per-row sampling with the settings on the device, the batcher's step
    sampler: logits (B, V); temperature (B,) f32, 0 = greedy; top_k (B,)
    int, V = no filter. Nothing is read back to the host.

    ``hot=False`` is the all-greedy shortcut: the caller knows every row is
    greedy (the settings come from its requests), so the sort and the noise
    are skipped."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not hot:
        return greedy
    v = logits.shape[-1]
    asc = torch.sort(logits, dim=-1).values
    idx = torch.clamp(v - top_k.to(torch.int64), 0, v - 1)
    kth = torch.gather(asc, 1, idx[:, None])
    noise = _gumbel(logits.shape, logits.device, generator)
    filt = torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)
    sampled = torch.argmax(filt / torch.clamp(temperature, min=1e-6)[:, None] + noise,
                           dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
