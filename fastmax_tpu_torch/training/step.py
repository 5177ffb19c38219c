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
  update of every leaf before the learning rate scales it;
- ``adafactor`` (optax's defaults: second moments factored over the two
  largest axes where the smaller is at least 128, decay 1 - t^-0.8, eps
  1e-30, each leaf's update clipped to an RMS of 1, scaled by the learning
  rate, then by the leaf's own RMS, at least 1e-3);
- ``lion`` (b1 0.9, b2 0.99: the sign of the interpolated momentum, plus
  ``weight_decay * p``, times the learning rate);
- ``MaskedOptimizer`` (PEFT) hands only the trainable leaves to one of them
  (or to ``quant_optim.AdamW8bit``), so the frozen ones have no state and
  the clip's norm is theirs alone.

Each takes ``max_norm``: the reference's chain clips by the global norm
first. Each schedule reads the count of updates before this one, as optax's
``scale_by_schedule`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
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


def clip_by_global_norm(grads: list, max_norm: Optional[float]) -> list:
    """optax's clip: every gradient scaled by max_norm / norm when norm >=
    max_norm, with no epsilon; None leaves them as they are."""
    if max_norm is None:
        return grads
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def f32(x: float) -> torch.Tensor:
    """A float32 scalar, for the optimizers' arithmetic on float32 scalars."""
    return torch.tensor(x, dtype=torch.float32)


class AdamW:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(schedule,
    b1, b2, eps, weight_decay=weight_decay))`` (no clipping when max_norm is
    None). The state is {"count", "mu", "nu"}, mu and nu in the order of
    ``tree_leaves(params)``; ``update`` changes the parameters in place."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 max_norm: Optional[float] = None, mu_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.mu_dtype = mu_dtype  # optax's: mu in this type (default: the parameter's)

    def init(self, params: dict) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict) -> None:
        leaves = tree_leaves(params)
        grads = clip_by_global_norm(grads, self.max_norm)
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


def _factored_dims(shape, min_dim: int):
    """optax's choice: the two largest axes (second largest, largest), where
    the second largest is at least ``min_dim``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """``optax.chain(optax.clip_by_global_norm(max_norm),
    optax.adafactor(schedule))`` with optax's defaults (see the module doc).
    The state is {"count", "v_row", "v_col", "v"}, one entry a leaf in the
    order of ``tree_leaves(params)``: a factored leaf has its row and column
    statistics (and v None), the others v (and the two None)."""

    def __init__(self, schedule: Callable, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3, max_norm: Optional[float] = None):
        self.schedule = schedule
        self.min_dim, self.decay_rate, self.eps = min_dim_size_to_factor, decay_rate, eps
        self.clipping_threshold, self.min_scale = clipping_threshold, min_scale
        self.max_norm = max_norm

    def init(self, params: dict) -> dict:
        state = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for p in tree_leaves(params):
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            if dims is None:
                row = col = None
                v = torch.zeros_like(p)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                row = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                col = p.new_zeros(shape[:d1] + shape[d1 + 1:])
                v = None
            state["v_row"].append(row)
            state["v_col"].append(col)
            state["v"].append(v)
        return state

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict) -> None:
        leaves = tree_leaves(params)
        grads = clip_by_global_norm(grads, self.max_norm)
        count = state["count"]
        decay = 1.0 - f32(count + 1) ** -self.decay_rate
        lr = self.schedule(count)
        state["count"] = count + 1
        for i, (p, g) in enumerate(zip(leaves, grads)):
            g2 = g * g + self.eps
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            if dims is None:
                v = decay * state["v"][i] + (1.0 - decay) * g2
                state["v"][i] = v
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                row = decay * state["v_row"][i] + (1.0 - decay) * g2.mean(dim=d0)
                col = decay * state["v_col"][i] + (1.0 - decay) * g2.mean(dim=d1)
                state["v_row"][i], state["v_col"][i] = row, col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (row / row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (col ** -0.5).unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / self.clipping_threshold, min=1.0)
            u = u * lr
            u = u * torch.clamp(torch.sqrt(torch.mean(p * p)), min=self.min_scale)
            p.add_(-u)


class Lion:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.lion(schedule,
    b1, b2, weight_decay=weight_decay, mu_dtype=mu_dtype))``. The state is
    {"count", "mu"}, mu in the order of ``tree_leaves(params)``."""

    def __init__(self, schedule: Callable, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3, max_norm: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay
        self.max_norm = max_norm
        self.mu_dtype = mu_dtype

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=self.mu_dtype)
                                   for p in tree_leaves(params)]}

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict) -> None:
        leaves = tree_leaves(params)
        grads = clip_by_global_norm(grads, self.max_norm)
        lr = self.schedule(state["count"])
        state["count"] += 1
        for p, g, mu in zip(leaves, grads, state["mu"]):
            u = torch.sign((1.0 - self.b1) * g + self.b1 * mu)
            mu.copy_((1.0 - self.b2) * g + self.b2 * mu)
            p.add_((u + self.weight_decay * p) * -lr)


class MaskedOptimizer:
    """The reference's ``masked_optimizer``, ``optax.multi_transform({"train":
    inner, "freeze": set_to_zero()})`` over a mask tree: only the leaves
    where ``mask`` is True get optimizer state and updates, and the inner
    chain's global-norm clip is taken over them alone. ``update`` takes the
    gradients of every leaf in ``tree_leaves`` order (None for a frozen one)."""

    def __init__(self, inner, mask: dict):
        self.inner = inner
        self.mask = [bool(m) for m in tree_leaves(mask)]

    def _select(self, items: list) -> dict:
        if len(items) != len(self.mask):
            raise ValueError(f"{len(items)} leaves against a mask of {len(self.mask)}")
        return {i: x for i, (x, m) in enumerate(zip(items, self.mask)) if m}

    def init(self, params: dict) -> dict:
        return self.inner.init(self._select(tree_leaves(params)))

    def update(self, params: dict, grads: list, state: dict) -> None:
        self.inner.update(self._select(tree_leaves(params)),
                          list(self._select(grads).values()), state)



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
