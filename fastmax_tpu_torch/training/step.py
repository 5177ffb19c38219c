"""The loss, the train step and the default optimizer (counterpart of
``fastmax_tpu/training/step.py``).

The optimizer is optax's, written out in PyTorch so that its numbers are
optax's, not ``torch.optim``'s defaults:

- ``warmup_cosine_decay_schedule`` is read at the update count *before* the
  step, so the first update has learning rate ``init_value`` (0) and, the
  decay being scaled by the same rate, no weight decay either;
- ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6);
- ``adamw`` (eps 1e-8, eps_root 0) adds ``weight_decay * p`` to the Adam
  update of every leaf before the learning rate scales it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..models import gpt
from ..models.config import Config
from ..utils.loss import cross_entropy


def tree_leaves(tree: dict) -> list:
    """The tensors of a nested dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable:
    """optax's schedule of the same name: linear from init_value to peak_value
    over warmup_steps, then cosine down to end_value at decay_steps."""
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(schedule,
    b1, b2, eps, weight_decay=weight_decay))`` (no clipping when max_norm is
    None). The state is {"count", "mu", "nu"}, mu and nu in the order of
    ``tree_leaves(params)``; ``update`` changes the parameters in place."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 max_norm: Optional[float] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm

    def init(self, params: dict) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict) -> None:
        leaves = tree_leaves(params)
        if self.max_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, g / norm * self.max_norm) for g in grads]
        count = state["count"]
        lr = self.schedule(count)
        state["count"] = count + 1
        c1 = 1.0 - self.b1 ** (count + 1)
        c2 = 1.0 - self.b2 ** (count + 1)
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-lr * u)


def make_loss_fn(cfg: Config, remat=True, plain: bool = False) -> Callable:
    """loss_fn(params, batch) for a (B, T+1) token matrix: inputs [:, :-1],
    targets [:, 1:]. ``plain=True`` sends the kernels' calls to their plain
    versions (a test hook)."""
    def loss_fn(params, batch):
        logits, _ = gpt.forward(params, cfg, batch[:, :-1], remat=remat, plain=plain)
        return cross_entropy(logits, batch[:, 1:])

    return loss_fn


def make_train_step(cfg: Config, optimizer: AdamW, *, remat=True, plain: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    one forward and backward and one optimizer update, in place."""
    loss_fn = make_loss_fn(cfg, remat, plain)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        optimizer.update(params, [p.grad for p in leaves], opt_state)
        return params, opt_state, loss.detach()

    return train_step


def default_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.02,
    beta1: float = 0.9,
    beta2: float = 0.95,
    max_norm: float = 1.0,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_lr: float = 6e-5,
) -> AdamW:
    """AdamW + clip + warmup-cosine, the reference's hyperparameter surface."""
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps,
                                            max(total_steps, warmup_steps + 1), min_lr)
    return AdamW(schedule, beta1, beta2, weight_decay=weight_decay, max_norm=max_norm)
