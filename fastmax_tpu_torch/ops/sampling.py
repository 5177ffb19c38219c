"""Token sampling: temperature and top-k by the Gumbel-max trick
(counterpart of ``fastmax_tpu/ops/sampling.py``).

The noise comes from an explicit ``torch.Generator`` where the reference
takes a ``jax.random`` key. The two give different bits from one seed, so
tests compare distributions.

``speculative_accept`` and ``speculative_accept_logq`` are the rejection
rules of speculative decoding (``inference/speculative.py``); both take an
optional leading batch dimension, so that many trials run in one call where
the reference maps a key over them. ``speculative_accept_traced`` is the
batcher's verify: per-slot temperature and top-k on the device.
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


def _residual_draw(res: torch.Tensor, p_a: torch.Tensor, generator) -> torch.Tensor:
    """A token of the (unnormalised) residual ``res`` (..., V) by Gumbel-max.
    p == q empties it, but then the draft's acceptance probability was 1 (up
    to rounding): the draw falls back to p_a, as the reference's does."""
    res = torch.where(res.sum(-1, keepdim=True) > 1e-9, res, p_a)
    log_res = torch.where(res > 0.0, torch.log(torch.clamp(res, min=1e-30)),
                          torch.full_like(res, float("-inf")))
    return torch.argmax(log_res + _gumbel(res.shape, res.device, generator), dim=-1)


def speculative_accept(logits: torch.Tensor, draft: torch.Tensor, temperature: float,
                       top_k: Optional[int] = None, *,
                       generator: Optional[torch.Generator] = None):
    """The rejection rule for a deterministic draft (Leviathan et al. 2023,
    the draft distribution a point mass): accept d_i with probability
    p_i(d_i); on the first rejection emit a token of p_i with d_i removed and
    renormalised; after k acceptances a bonus token of p_k. Every emitted
    token is marginally distributed as p_i.

    logits (..., k+1, V): the verifier's over [current, drafts]; draft
    (..., k). Returns (a (...,), tokens (..., k+1)): a in [0, k] drafts
    accepted, tokens[..., :a] the accepted drafts and tokens[..., a] the
    resampled or bonus token; entries past a are undefined."""
    v = logits.shape[-1]
    vocab = torch.arange(v, device=logits.device)
    logq = torch.where(vocab == draft[..., None].long(), 0.0, float("-inf"))
    return speculative_accept_logq(logits, draft, logq, temperature, top_k, generator=generator)


def speculative_accept_logq(logits: torch.Tensor, draft: torch.Tensor, logq: torch.Tensor,
                            temperature: float, top_k: Optional[int] = None, *,
                            generator: Optional[torch.Generator] = None):
    """The general rejection rule: d_i, drawn from q_i, is accepted with
    probability min(1, p_i(d_i) / q_i(d_i)); the first rejection emits a
    token of norm(max(p_i - q_i, 0)); full acceptance a bonus token of p_k.

    logits (..., k+1, V); draft (..., k); logq (..., k, V): the
    log-probabilities the drafts were drawn from (shaped by the drafter's
    temperature and top-k). Returns (a, tokens) as ``speculative_accept``."""
    k, v = draft.shape[-1], logits.shape[-1]
    lead = draft.shape[:-1]
    logp = filtered_log_probs(logits, temperature, top_k)  # (..., k+1, V)
    u = torch.rand(lead + (k,), generator=generator, device=logits.device)
    d = draft.long()[..., None]
    diff = torch.gather(logp[..., :k, :], -1, d)[..., 0] - torch.gather(logq, -1, d)[..., 0]
    ratio = torch.exp(torch.minimum(diff, torch.zeros_like(diff)))
    a = torch.cumprod((u < ratio).to(torch.int32), dim=-1).sum(-1)  # accepted drafts in [0, k]
    # emission: the residual max(p_a - q_a, 0) after a rejection (a < k), plain p_k after
    # full acceptance (q = 0 there)
    def row(x, i):  # x[..., i, :] at each trial's own i
        return torch.gather(x, -2, i.long()[..., None, None].expand(lead + (1, v)))[..., 0, :]

    p_a = torch.exp(row(logp, a))
    q_row = row(logq, torch.clamp(a, max=k - 1))
    q_a = torch.where((a < k)[..., None], torch.exp(q_row), torch.zeros_like(q_row))
    nxt = _residual_draw(torch.clamp(p_a - q_a, min=0.0), p_a, generator).to(draft.dtype)
    tokens = torch.cat([draft, torch.zeros(lead + (1,), dtype=draft.dtype,
                                           device=draft.device)], dim=-1)
    tokens.scatter_(-1, a.long()[..., None], nxt[..., None])
    return a, tokens


def speculative_accept_traced(logits: torch.Tensor, draft: torch.Tensor,
                              temperature: torch.Tensor, top_k: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None, hot: bool = True):
    """The batcher's verify over (B, k+1, V) logits and (B, k) drafts, with
    the settings on the device, as ``sample_traced``'s: temperature (B,) f32,
    0 = greedy (a draft is accepted while it equals the argmax, and the
    decided tokens are the argmaxes); top_k (B,) int, V = no filter; the
    other rows take the point-mass rejection rule. Returns (a (B,), cand (B,
    k+1)): cand[b, :a[b] + 1] are row b's decided tokens. ``hot=False`` is
    the all-greedy shortcut."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, k+1)
    draft = draft.to(torch.int32)
    a_g = torch.cumprod((draft == greedy[:, :-1]).to(torch.int32), dim=1).sum(1)
    if not hot:
        return a_g, greedy
    b, kd, v = logits.shape[0], draft.shape[1], logits.shape[-1]
    asc = torch.sort(logits, dim=-1).values
    idx = torch.clamp(v - top_k.to(torch.int64), 0, v - 1)
    kth = torch.gather(asc, -1, idx[:, None, None].expand(b, kd + 1, 1))
    filt = torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)
    logp = torch.log_softmax(filt / torch.clamp(temperature, min=1e-6)[:, None, None], dim=-1)
    u = torch.rand((b, kd), generator=generator, device=logits.device)
    logp_d = torch.gather(logp[:, :kd], -1, draft.long()[..., None])[..., 0]
    a_s = torch.cumprod((u < torch.exp(logp_d)).to(torch.int32), dim=1).sum(1)
    # the residual at a_s: p_a with the rejected draft removed (a_s < k), plain p_k after
    # full acceptance
    p_a = torch.gather(torch.exp(logp), 1, a_s.long()[:, None, None].expand(b, 1, v))[:, 0]
    d_a = torch.gather(draft, 1, torch.clamp(a_s, max=kd - 1).long()[:, None])[:, 0]
    vocab = torch.arange(v, device=logits.device)
    res = torch.where((vocab[None, :] == d_a[:, None]) & (a_s[:, None] < kd),
                      torch.zeros_like(p_a), p_a)
    nxt_s = _residual_draw(res, p_a, generator).to(torch.int32)
    cand_s = torch.cat([draft, torch.zeros((b, 1), dtype=torch.int32, device=draft.device)], 1)
    cand_s.scatter_(1, a_s.long()[:, None], nxt_s[:, None])
    hot_rows = temperature > 0
    return (torch.where(hot_rows, a_s, a_g),
            torch.where(hot_rows[:, None], cand_s, greedy))
