"""Loss functions (counterpart of ``fastmax_tpu/utils/loss.py``)."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -1):
    """Mean cross entropy over the targets that are not ``ignore_index``, in
    float32. logits (..., V), targets (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.where(targets == ignore_index, torch.zeros_like(targets), targets)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    mask = (targets != ignore_index).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
