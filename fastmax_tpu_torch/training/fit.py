"""The fit loop (counterpart of ``fastmax_tpu/training/fit.py``).

Gradient accumulation runs the micro-batches' backward passes into the
parameters' ``.grad`` (their sum), divides by the micro-batch count and takes
one optimizer update, as the reference's accumulate/apply pair does. Logging,
periodic evaluation, checkpoints and ``max_tokens`` follow the reference.
The train state is saved with ``torch.save``.

A ``trainable`` mask tree (PEFT) leaves ``requires_grad`` on its True
leaves only, so no gradient of a frozen base is ever formed (the reference
forms every float gradient and its masked optimizer drops the frozen ones:
the updates are the same), and ``build_optimizer(train, trainable)`` wraps
the optimizer in ``MaskedOptimizer``. Batches are (B, T+1) token matrices
or (inputs, labels) tuples (SFT).

Ported: the ``adamw`` optimizer. ``adamw8bit``, ``adafactor`` and ``lion``
and a device mesh are not ported yet.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..models.config import Config
from ..utils.args import EvalArgs, TrainArgs
from ..utils.flops import mfu
from .step import AdamW, MaskedOptimizer, make_loss_fn, tree_leaves, warmup_cosine_decay_schedule

STATE_FILE = "train_state.pt"


class TrainState:
    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


def build_optimizer(train: TrainArgs, trainable: Optional[dict] = None):
    """AdamW with the clip and the warmup-cosine schedule of ``train``; with a
    ``trainable`` mask tree, only its True leaves are optimized."""
    schedule = warmup_cosine_decay_schedule(
        0.0, train.learning_rate, train.lr_warmup_steps,
        max(train.max_iters, train.lr_warmup_steps + 1), train.min_lr)
    if train.optimizer != "adamw":
        raise NotImplementedError(f"optimizer {train.optimizer!r} is not ported yet "
                                  "(ROADMAP queue A): the port has 'adamw'")
    opt = AdamW(schedule, train.beta1, train.beta2, weight_decay=train.weight_decay,
                max_norm=train.max_norm)
    return opt if trainable is None else MaskedOptimizer(opt, trainable)


def fit(
    cfg: Config,
    state: TrainState,
    optimizer: AdamW,
    train_iter: Iterator[np.ndarray],
    *,
    train: TrainArgs,
    eval_args: Optional[EvalArgs] = None,
    val_iter_fn: Optional[Callable[[], Iterator[np.ndarray]]] = None,
    logger=None,
    loss_fn: Optional[Callable] = None,
    checkpoint_fn: Optional[Callable] = None,
    remat=True,
    plain: bool = False,
    trainable: Optional[dict] = None,
) -> TrainState:
    """Run the training loop; batches from ``train_iter`` are (B, T+1) integer
    token matrices (inputs [:, :-1], targets [:, 1:]) or (inputs, labels)
    tuples for ``loss_fn``, moved to the parameters' device. ``trainable``
    (a mask tree like the params) names the leaves that train, all of them
    by default; ``optimizer`` must then be built with the same mask.
    ``plain=True`` sends the kernels' calls to their plain versions (a test
    hook)."""
    loss_fn = loss_fn or make_loss_fn(cfg, remat=remat, plain=plain)
    grad_accum = train.gradient_accumulation_iters()
    leaves = tree_leaves(state.params)
    train_mask = [True] * len(leaves) if trainable is None else \
        [bool(m) for m in tree_leaves(trainable)]
    for p, m in zip(leaves, train_mask):
        p.requires_grad_(m)
    device = leaves[0].device
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    dtype = str(leaves[0].dtype).removeprefix("torch.")
    n_params = sum(p.numel() for p in leaves)

    def place(batch):
        if isinstance(batch, tuple):
            return tuple(place(b) for b in batch)
        return torch.as_tensor(np.asarray(batch), dtype=torch.long).to(device)

    t_start = time.perf_counter()
    tokens_seen = 0
    while state.step < train.max_iters:
        for p in leaves:
            p.grad = None
        losses = []
        for _ in range(grad_accum):
            batch = place(next(train_iter))
            loss = loss_fn(state.params, batch)
            loss.backward()
            losses.append(loss.detach())
            first = batch[0] if isinstance(batch, tuple) else batch
            tokens_seen += first.shape[0] * (first.shape[1] - 1)
        grads = [None if not m else torch.zeros_like(p) if p.grad is None else p.grad / grad_accum
                 for p, m in zip(leaves, train_mask)]
        optimizer.update(state.params, grads, state.opt_state)
        state.step += 1
        loss_val = float(torch.stack(losses).mean())

        if logger is not None and state.step % train.log_interval == 0:
            dt = time.perf_counter() - t_start
            tps = tokens_seen / max(dt, 1e-9)
            metrics = {"loss": loss_val, "tokens": tokens_seen, "tokens_per_sec": tps}
            est = mfu(tps, cfg, n_params, first.shape[1] - 1, kind, dtype)
            if est is not None:
                metrics["est_mfu"] = est
            logger.log_dict(metrics, state.step)

        if eval_args is not None and val_iter_fn is not None and \
                state.step % eval_args.interval == 0:
            val_losses = []
            with torch.no_grad():
                for i, vbatch in enumerate(val_iter_fn()):
                    if i >= eval_args.max_iters:
                        break
                    val_losses.append(float(loss_fn(state.params, place(vbatch))))
            if logger is not None and val_losses:
                vl = float(np.mean(val_losses))
                logger.log_dict({"val_loss": vl, "val_ppl": float(np.exp(min(vl, 20)))},
                                state.step)

        if checkpoint_fn is not None and state.step % train.save_interval == 0:
            checkpoint_fn(state)

        if train.max_tokens is not None and tokens_seen >= train.max_tokens:
            break

    if checkpoint_fn is not None:
        checkpoint_fn(state)
    return state


# ------------------------------------------------------------- checkpoints


def save_train_state(state: TrainState, path: Path) -> None:
    """``torch.save`` of {params, opt_state, step} into ``path/train_state.pt``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    params = _detach(state.params)
    tmp = path / f"{STATE_FILE}.{os.getpid()}.tmp"
    torch.save({"params": params, "opt_state": state.opt_state, "step": state.step}, tmp)
    os.replace(tmp, path / STATE_FILE)


def load_train_state(path: Path, device=None) -> TrainState:
    """Restore a TrainState saved by ``save_train_state`` onto ``device``."""
    data = torch.load(Path(path) / STATE_FILE, map_location=device, weights_only=True)
    return TrainState(data["params"], data["opt_state"], int(data["step"]))


def has_train_state(path: Path) -> bool:
    return (Path(path) / STATE_FILE).is_file()


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
