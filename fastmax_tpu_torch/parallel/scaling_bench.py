"""Scaling-efficiency harness (counterpart of
``fastmax_tpu/parallel/scaling_bench.py``): the train step's time on meshes
of 1, 2, 4, ... ranks. Efficiency(P) = tokens/s(P) / (P * tokens/s(1)).

For each size P above one it starts P fresh ranks
(``collectives.spawn_local``) on a (P // fsdp, fsdp, 1) mesh with fsdp =
min(P, 8), as the reference does, and times ``training/step.make_train_step``
on them (AdamW at 1e-4, full remat, f32 weights from seed 0, per_device_batch
rows of seq_len + 1 tokens a rank): one step first (the kernels' first
launch), then ``iters`` steps, then one read of the loss. Size one, the
reference's mesh of one device, is the unsharded step in this process. Where each rank has its own card the ranks are NCCL ranks,
up to ``torch.cuda.device_count()``; ``backend="gloo"`` puts ``max_devices``
ranks on the cards there are (several to a card: a check of the mechanics,
not a scaling figure); ``device="cpu"`` runs gloo ranks on the CPU.

    python -m fastmax_tpu_torch.parallel.scaling_bench --model_name pythia-160m

It starts its own ranks, so it runs as one process, not under torchrun.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import Config


def _step_time(model_name: str, seq_len: int, per_device_batch: int, data: int, fsdp: int,
               iters: int, device: Optional[str]) -> Optional[float]:
    """The seconds of a train step: on a rank of the (data, fsdp, 1) mesh of
    this process's group (rank 0's; None on the others), or at data * fsdp
    == 1 the unsharded step in this process."""
    from ..models import gpt
    from ..training.step import AdamW, make_train_step, tree_leaves
    from .sharding import make_mesh, shard_params

    sharded = data * fsdp > 1
    if device == "cpu":
        dev = torch.device("cpu")
    elif sharded:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = Config.from_name(model_name)
    cfg.block_size = min(cfg.block_size, seq_len)
    params = gpt.init_params(cfg, 0, torch.float32, dev)
    plan = splits = None
    if sharded:
        params = shard_params(params, make_mesh(data, fsdp, 1), cfg, tp=False, train=True)
        plan = params.plan
        splits = plan.leaf_splits(tree_leaves(params))
    optimizer = AdamW(lambda count: 1e-4)
    state = optimizer.init(params, splits)
    step = make_train_step(cfg, optimizer, remat=True, shard=plan)
    rows = per_device_batch * data * fsdp
    batch = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                              (rows, seq_len + 1)), device=dev)
    float(step(params, state, batch)[2])  # the first launches; the read waits for the device
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step(params, state, batch)[2]
    float(loss)
    dt = (time.perf_counter() - t0) / iters
    return dt if not sharded or dist.get_rank() == 0 else None


def run(
    model_name: str = "pythia-160m",
    seq_len: int = 256,
    per_device_batch: int = 4,
    max_devices: Optional[int] = None,
    device: Optional[str] = None,
    backend: Optional[str] = None,
    iters: int = 5,
) -> dict:
    """{P: {"tokens_per_sec", "step_time_s", "efficiency"}} for P in (1, 2,
    4, ...) up to the ranks available: the cards (NCCL), ``max_devices``
    ranks on them (gloo), or ``max_devices`` ranks on the CPU (default 1)."""
    from . import collectives as col

    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise RuntimeError("scaling_bench starts its own ranks: run it as one process, not "
                           "under torchrun")
    backend = backend or ("gloo" if on_cpu else "nccl")
    cards = 0 if on_cpu else torch.cuda.device_count()
    if backend == "nccl":
        n = min(max_devices or cards, cards)
    else:
        n = max_devices or max(cards, 1)
    results, base_tps = {}, None
    for p in [p for p in (1, 2, 4, 8, 16, 32) if p <= n]:
        fsdp = min(p, 8)
        data = p // fsdp
        args = (model_name, seq_len, per_device_batch, data, fsdp, iters,
                "cpu" if on_cpu else None)
        dt = _step_time(*args) if p == 1 else \
            col.spawn_local(_step_time, p, backend, args=args, timeout=1800)[0]
        tps = per_device_batch * p * seq_len / dt
        if base_tps is None:
            base_tps = tps
        eff = tps / (p * base_tps)
        results[p] = {"tokens_per_sec": tps, "step_time_s": dt, "efficiency": eff}
        kind = "cpu" if on_cpu else torch.cuda.get_device_name(0)
        where = backend if p > 1 else "this process"
        print(f"devices={p} ({where}, {kind}): {tps:,.0f} tok/s, step {dt * 1e3:.1f} ms, "
              f"efficiency {eff:.2%}")
    return results


def main(args=None) -> dict:
    from ..utils.cli import CLI

    out = CLI(run, args)
    print(json.dumps({str(k): v for k, v in out.items()}, indent=2))
    return out


if __name__ == "__main__":
    main()
