"""Loss functions (counterpart of ``fastmax_tpu/utils/loss.py``): ``cross_entropy``
and ``chunked_cross_entropy``, the lm_head and the loss a chunk of positions
at a time."""

from __future__ import annotations

import torch


def cross_entropy_parts(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -1):
    """(sum of the float32 NLL over the targets that are not ``ignore_index``,
    their count): the two halves of ``cross_entropy``, which a sharded loss
    sums over the ranks' rows before it divides."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.where(targets == ignore_index, torch.zeros_like(targets), targets)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    mask = (targets != ignore_index).float()
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -1):
    """Mean cross entropy over the targets that are not ``ignore_index``, in
    float32. logits (..., V), targets (...)."""
    total, count = cross_entropy_parts(logits, targets, ignore_index)
    return total / torch.clamp(count, min=1.0)


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: dict, targets: torch.Tensor,
                          chunk_size: int = 128, ignore_index: int = -1, *,
                          logits_fn=None, parts: bool = False):
    """Cross entropy of ``linear(lm_head, hidden)`` against ``targets``, ``chunk_size``
    positions at a time, so the f32 logits of only one chunk exist at once.
    hidden (B, T, E), targets (B, T); T is padded to a multiple of the chunk
    with ignored targets, as the reference does. ``logits_fn(hidden_chunk)``
    replaces the lm_head (a vocab-split head gathered over the mesh: the
    log-softmax is the whole vocabulary's); ``parts=True`` returns
    ``cross_entropy_parts``' (sum, count)."""
    from ..ops.linear import linear

    if logits_fn is None:
        def logits_fn(h):
            return linear(lm_head, h)

    b, t, e = hidden.shape
    if chunk_size <= 0 or t <= chunk_size:
        total, count = cross_entropy_parts(logits_fn(hidden), targets, ignore_index)
        return (total, count) if parts else total / torch.clamp(count, min=1.0)
    pad = (-t) % chunk_size
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=ignore_index)
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, t + pad, chunk_size):
        tgt = targets[:, c0:c0 + chunk_size]
        logp = torch.log_softmax(logits_fn(hidden[:, c0:c0 + chunk_size]).float(), dim=-1)
        safe = torch.where(tgt == ignore_index, torch.zeros_like(tgt), tgt)
        nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
        mask = (tgt != ignore_index).float()
        loss_sum = loss_sum + torch.sum(nll * mask)
        count = count + torch.sum(mask)
    return (loss_sum, count) if parts else loss_sum / torch.clamp(count, min=1.0)
