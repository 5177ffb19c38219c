"""Training-step MFU benchmark (counterpart of ``fastmax_tpu/training/bench_mfu.py``).

Times the train step of a registry model in bf16 on one device: the
chunked-CE loss of the finetune recipes over ``gpt.forward_hidden`` under a
remat policy, the backward, and one optimizer update behind the global-norm
clip. A warm step first (its time is ``compile_s``: the kernels' first
launch), then ``iters`` steps timed between two synchronisations. MFU is
``utils/flops.estimate_flops`` (forward + 2x backward, with the attention
term) over the step time and the card's bf16 peak (``device_peak_flops``),
null where no peak is known (the CPU). ``peak_hbm_gb`` is the allocator's
peak over this run.

    python -m fastmax_tpu_torch.training.bench_mfu --model_name tiny-llama-1.1b \\
        --micro_batch 8 --seq_len 2048 --remat attn [--device cpu]

Prints one JSON line with the reference's keys. On a group of ranks
(``torchrun``; started alone at ``fsdp``/``tp`` above 1 it raises, naming
the line) the step is the sharded one of the reference's mesh
(bench_mfu.py:58-93): ``fsdp`` 0 means ``world // tp``, the rest of the world
is the data axis, each rank trains its rows of the micro-batch on its shards
(``shard_params(..., train=True)``), and MFU is taken against the bf16 peak of
all the ranks' cards; ``peak_hbm_gb`` is the rank's own. Rank 0 prints.

    torchrun --nproc_per_node 4 -m fastmax_tpu_torch.training.bench_mfu --fsdp 2 --tp 2 ...
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..inference.engine import default_device
from ..models import gpt
from ..models.config import Config
from ..parallel import collectives as col
from ..parallel.sharding import shard_params, train_mesh_from_env
from ..utils.flops import device_peak_flops, estimate_flops
from ..utils.loss import chunked_cross_entropy
from ..utils.profiling import device_memory_stats
from .quant_optim import AdamW8bit
from .step import Adafactor, AdamW, Lion, tree_leaves


def make_bench_loss_fn(cfg: Config, remat, lm_head_chunk: int = 128, unroll: int = 1,
                       shard=None):
    """Chunked-CE loss (the finetune recipes' memory-bounded pattern); with
    ``shard``, the global batch's mean (its gradient the rank's share)."""
    def loss_fn(params, batch):
        inputs, targets = batch[:, :-1], batch[:, 1:]
        hidden = gpt.forward_hidden(params, cfg, inputs, remat=remat, unroll=unroll,
                                    shard=shard)
        if shard is None:
            return chunked_cross_entropy(hidden, params["lm_head"], targets, lm_head_chunk)
        return shard.global_mean(*chunked_cross_entropy(
            hidden, None, targets, lm_head_chunk, logits_fn=gpt.lm_head_fn(params, shard),
            parts=True))

    return loss_fn


def build_bench_optimizer(name: str, mu_dtype: str = "bfloat16"):
    """The reference's four, each behind ``clip_by_global_norm(1.0)``, at its
    constant learning rate."""
    mu = getattr(torch, mu_dtype)
    if name == "adamw":
        return AdamW(lambda c: 3e-4, 0.9, 0.95, weight_decay=0.02, max_norm=1.0, mu_dtype=mu)
    if name == "adafactor":
        return Adafactor(lambda c: 3e-4, max_norm=1.0)
    if name == "lion":
        return Lion(lambda c: 3e-5, weight_decay=0.02, max_norm=1.0, mu_dtype=mu)
    if name == "adamw8bit":
        return AdamW8bit(lambda c: 3e-4, 0.9, 0.95, weight_decay=0.02, max_norm=1.0)
    raise ValueError(f"unknown optimizer {name!r}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    model_name: str = "pythia-410m",
    seq_len: int = 1024,
    micro_batch: int = 8,
    attn_alg: Optional[str] = None,
    remat: str = "full",
    optimizer: str = "adamw",
    mu_dtype: str = "bfloat16",
    fsdp: int = 0,
    tp: int = 1,
    iters: int = 10,
    lm_head_chunk: int = 128,
    unroll: int = 1,
    accum: int = 1,
    trace_dir: Optional[str] = None,
    device=None,
) -> dict:
    """Measure the train step's MFU on the card (``device="cpu"`` for the
    CPU). Alone: one device (``fsdp`` 0 or 1, ``tp`` 1). On a group of ranks:
    the (world // (fsdp * tp), fsdp, tp) mesh. ``accum`` > 1 sums the
    gradients of ``accum`` sub-batches before the update."""
    module = "fastmax_tpu_torch.training.bench_mfu"
    if max(fsdp, 1) * tp > 1:
        col.require_ranks(max(fsdp, 1) * tp, module, col.TRAINING_TIMEOUT, "fsdp * tp")
    world = dist.get_world_size() if dist.is_initialized() else 1
    fsdp = fsdp or max(world // tp, 1)
    if micro_batch % accum:
        raise ValueError(f"micro_batch {micro_batch} must divide by accum={accum}")
    mesh = train_mesh_from_env(world // (fsdp * tp), fsdp, tp, module, micro_batch // accum)
    device = default_device(device)
    cfg = Config.from_name(model_name)
    # exactly seq_len positions: the rope cache shrinks for short runs and
    # grows for runs beyond the native context
    cfg.block_size = seq_len
    if attn_alg:
        cfg.attn_alg = attn_alg
    if remat in ("none", "False", "false"):
        remat = False
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    params = gpt.init_params(cfg, 0, torch.bfloat16, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    plan = splits = None
    if mesh is not None:
        params = shard_params(params, mesh, cfg, train=True)
        plan = params.plan
    leaves = tree_leaves(params)
    if plan is not None:
        splits = plan.leaf_splits(leaves)
    loss_fn = make_bench_loss_fn(cfg, remat, lm_head_chunk, unroll, shard=plan)
    opt = build_bench_optimizer(optimizer, mu_dtype)
    opt_state = opt.init(params, splits)
    for p in leaves:
        p.requires_grad_(True)

    batch = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (micro_batch, seq_len + 1))
    ).to(device)
    chunks = batch.chunk(accum)
    if plan is not None:  # each rank's rows of each sub-batch
        chunks = [plan.batch_rows(c) for c in chunks]

    def step() -> torch.Tensor:
        for p in leaves:
            p.grad = None
        total = 0.0
        for chunk in chunks:
            loss = loss_fn(params, chunk)
            loss.backward()  # gradients of the sub-batches add up in .grad
            total = total + loss.detach()
        grads = [p.grad if accum == 1 else p.grad / accum for p in leaves]
        if plan is not None:
            grads = plan.sync_grads(leaves, grads)
        opt.update(params, grads, opt_state, splits)
        return total / accum

    t0 = time.perf_counter()
    loss = step()
    float(loss)
    compile_s = time.perf_counter() - t0

    if trace_dir:
        from ..utils.profiling import trace

        with trace(trace_dir):
            loss = step()
            _sync(device)

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    _sync(device)
    dt = (time.perf_counter() - t0) / iters

    tokens_per_step = micro_batch * seq_len
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    peak = device_peak_flops(kind, "bfloat16")
    flops_per_seq = estimate_flops(cfg, n_params, seq_len, training=True)
    # against the peak of every rank's card, as the reference's n_dev * peak
    mfu = None if peak is None else flops_per_seq * micro_batch / dt / (peak * world)
    mem = device_memory_stats(device)
    return {
        "model": model_name,
        "remat": remat or "none",
        "unroll": unroll,
        "lm_head_chunk": lm_head_chunk,
        "optimizer": optimizer,
        "accum": accum,
        "attn_alg": cfg.attn_alg,
        "devices": world,
        "device_kind": kind,
        "micro_batch": micro_batch,
        "seq_len": seq_len,
        "n_params": n_params,
        "step_time_ms": round(dt * 1e3, 2),
        "tokens_per_sec": round(tokens_per_step / dt, 1),
        "mfu": None if mfu is None else round(float(mfu), 4),
        "loss": round(float(loss), 4),
        "compile_s": round(compile_s, 1),
        "peak_hbm_gb": round(mem["peak_bytes_in_use"] / 2**30, 2),
    }


def main(args=None) -> dict:
    """The command line: ``run``'s parameters as flags (``utils/cli.py``);
    prints the result as one JSON line."""
    from ..utils.cli import CLI

    out = CLI(run, args)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
