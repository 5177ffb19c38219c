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

On a mesh (``parallel/sharding.py``) each leaf is a rank's shard and
``init``/``update`` take the leaves' ``LeafSplit``s (``splits``): the global
norm sums each leaf's squares over the axes it is split on (a leaf whole over
``model`` counts once, data replicas are not summed); AdamW and Lion are
elementwise on the shard; Adafactor factors by the whole leaf's shape and
sums its row and column statistics and its update and parameter RMS over the
axes the leaf is split on. ``gather_state``/``cut_state`` turn a rank's state
into the whole one that ``fit`` saves, and back, at any mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..models import gpt
from ..models.config import Config
from ..parallel import collectives as col
from ..utils.loss import cross_entropy, cross_entropy_parts


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


def _sharded(splits) -> bool:
    return splits is not None and any(sp is not None and sp.dims for sp in splits)


def global_sq_norm(grads: list, splits=None) -> torch.Tensor:
    """The squared global norm of ``grads``. On a mesh (``splits``): each
    leaf's squares summed over the axes it is split on, a whole one counted
    once, the same on every rank."""
    if not _sharded(splits):
        return sum(torch.sum(g * g) for g in grads)
    parts: dict = {}
    for g, sp in zip(grads, splits):
        parts[sp.axes] = parts.get(sp.axes, 0) + torch.sum(g * g)
    mesh = splits[0].mesh
    total = 0
    for axes in sorted(parts, key=lambda a: tuple(sorted(a))):
        t = parts[axes]
        for axis in sorted(axes):
            t = col.all_reduce(t, mesh.group(axis))
        total = total + t
    return total


def clip_by_global_norm(grads: list, max_norm: Optional[float], splits=None) -> list:
    """optax's clip: every gradient scaled by max_norm / norm when norm >=
    max_norm, with no epsilon; None leaves them as they are. ``splits``: the
    leaves' ``LeafSplit``s on a mesh (the norm of the whole tree)."""
    if max_norm is None:
        return grads
    norm = torch.sqrt(global_sq_norm(grads, splits))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _per_leaf(state: dict, keys, fn) -> dict:
    """``state`` with ``fn(i, x)`` applied to entry i of each list ``keys``."""
    out = dict(state)
    for key in keys:
        out[key] = [None if x is None else fn(i, x) for i, x in enumerate(state[key])]
    return out


def _drop(dims: dict, dim: int) -> dict:
    """A leaf's split dims on a tensor that lacks whole-leaf dim ``dim`` (a
    statistic reduced over it)."""
    return {d - (d > dim): a for d, a in dims.items() if d != dim}


def _mean(x: torch.Tensor, dim: int, sp, keepdim: bool = False, whole_dim: Optional[int] = None):
    """The mean over ``dim`` of the whole leaf, from a rank's shard ``x``
    (``whole_dim``: that dim's index in the whole leaf, if it differs)."""
    if sp is None or not sp.dims:
        return x.mean(dim=dim, keepdim=keepdim)
    wd = dim if whole_dim is None else whole_dim
    return sp.sum_over(x.sum(dim=dim, keepdim=keepdim), (wd,)) / sp.whole[wd]


def _rms(x: torch.Tensor, sp) -> torch.Tensor:
    if sp is None or not sp.dims:
        return torch.sqrt(torch.mean(x * x))
    return torch.sqrt(sp.sum_all(torch.sum(x * x)) / math.prod(sp.whole))


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

    def init(self, params: dict, splits=None) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def gather_state(self, state: dict, splits) -> dict:
        return _per_leaf(state, ("mu", "nu"), lambda i, x: splits[i].gather(x))

    def cut_state(self, state: dict, splits) -> dict:
        return _per_leaf(state, ("mu", "nu"), lambda i, x: splits[i].cut(x))

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict, splits=None) -> None:
        leaves = tree_leaves(params)
        grads = clip_by_global_norm(grads, self.max_norm, splits)
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

    def _dims(self, p, sp):
        """The factored dims, by the whole leaf's shape."""
        return _factored_dims(tuple(p.shape) if sp is None else sp.whole, self.min_dim)

    def init(self, params: dict, splits=None) -> dict:
        state = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for i, p in enumerate(tree_leaves(params)):
            dims = self._dims(p, None if splits is None else splits[i])
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

    def _stat_dims(self, i: int, sp, key: str):
        """The split dims of leaf i's statistic ``key`` (its leaf's dims less
        the one it is reduced over)."""
        if key == "v":
            return sp.dims
        d1, d0 = _factored_dims(sp.whole, self.min_dim)
        return _drop(sp.dims, d0 if key == "v_row" else d1)

    def gather_state(self, state: dict, splits) -> dict:
        return {**state, **{key: [None if x is None else splits[i].gather(
            x, self._stat_dims(i, splits[i], key)) for i, x in enumerate(state[key])]
            for key in ("v_row", "v_col", "v")}}

    def cut_state(self, state: dict, splits) -> dict:
        return {**state, **{key: [None if x is None else splits[i].cut(
            x, self._stat_dims(i, splits[i], key)) for i, x in enumerate(state[key])]
            for key in ("v_row", "v_col", "v")}}

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict, splits=None) -> None:
        leaves = tree_leaves(params)
        grads = clip_by_global_norm(grads, self.max_norm, splits)
        count = state["count"]
        decay = 1.0 - f32(count + 1) ** -self.decay_rate
        lr = self.schedule(count)
        state["count"] = count + 1
        for i, (p, g) in enumerate(zip(leaves, grads)):
            sp = None if splits is None else splits[i]
            g2 = g * g + self.eps
            dims = self._dims(p, sp)
            if dims is None:
                v = decay * state["v"][i] + (1.0 - decay) * g2
                state["v"][i] = v
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                row = decay * state["v_row"][i] + (1.0 - decay) * _mean(g2, d0, sp)
                col = decay * state["v_col"][i] + (1.0 - decay) * _mean(g2, d1, sp)
                state["v_row"][i], state["v_col"][i] = row, col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = _mean(row, reduced_d1, sp, keepdim=True, whole_dim=d1)
                row_factor = (row / row_mean) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (col ** -0.5).unsqueeze(d1)
            u = u / torch.clamp(_rms(u, sp) / self.clipping_threshold, min=1.0)
            u = u * lr
            u = u * torch.clamp(_rms(p, sp), min=self.min_scale)
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

    def init(self, params: dict, splits=None) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=self.mu_dtype)
                                   for p in tree_leaves(params)]}

    def gather_state(self, state: dict, splits) -> dict:
        return _per_leaf(state, ("mu",), lambda i, x: splits[i].gather(x))

    def cut_state(self, state: dict, splits) -> dict:
        return _per_leaf(state, ("mu",), lambda i, x: splits[i].cut(x))

    @torch.no_grad()
    def update(self, params: dict, grads: list, state: dict, splits=None) -> None:
        leaves = tree_leaves(params)
        grads = clip_by_global_norm(grads, self.max_norm, splits)
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

    def _splits(self, splits):
        return None if splits is None else list(self._select(splits).values())

    def init(self, params: dict, splits=None) -> dict:
        return self.inner.init(self._select(tree_leaves(params)), self._splits(splits))

    def gather_state(self, state: dict, splits) -> dict:
        return self.inner.gather_state(state, self._splits(splits))

    def cut_state(self, state: dict, splits) -> dict:
        return self.inner.cut_state(state, self._splits(splits))

    def update(self, params: dict, grads: list, state: dict, splits=None) -> None:
        self.inner.update(self._select(tree_leaves(params)),
                          list(self._select(grads).values()), state, self._splits(splits))



def make_loss_fn(cfg: Config, remat=True, plain: bool = False, shard=None) -> Callable:
    """loss_fn(params, batch) for a (B, T+1) token matrix: inputs [:, :-1],
    targets [:, 1:]. ``plain=True`` sends the kernels' calls to their plain
    versions (a test hook). ``shard`` (a ``ShardPlan`` in training mode):
    ``params`` and ``batch`` are the rank's; the loss is the mean over the
    global batch, its gradient the rank's share (``ShardPlan.global_mean``)."""
    def loss_fn(params, batch):
        logits, _ = gpt.forward(params, cfg, batch[:, :-1], remat=remat, plain=plain,
                                shard=shard)
        if shard is None:
            return cross_entropy(logits, batch[:, 1:])
        return shard.global_mean(*cross_entropy_parts(logits, batch[:, 1:]))

    return loss_fn


def make_train_step(cfg: Config, optimizer: AdamW, *, remat=True, plain: bool = False,
                    shard=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    one forward and backward and one optimizer update, in place. ``shard``:
    ``params`` and ``opt_state`` are a rank's shards (``shard_params(...,
    train=True)``), ``batch`` the global one, of which the rank takes its
    rows; the loss returned is the global batch's."""
    loss_fn = make_loss_fn(cfg, remat, plain, shard)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if shard is not None:
            batch = shard.batch_rows(batch)
        loss = loss_fn(params, batch)
        loss.backward()
        grads = [p.grad for p in leaves]
        splits = None
        if shard is not None:
            grads = shard.sync_grads(leaves, grads)
            splits = shard.leaf_splits(leaves)
        optimizer.update(params, grads, opt_state, splits)
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
