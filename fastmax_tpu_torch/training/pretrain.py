"""From-scratch pretraining recipe (counterpart of
``fastmax_tpu/training/pretrain.py``).

  --data_format openwebtext   nanoGPT train.bin/val.bin memmaps (+ meta.json dtype;
                              ``scripts/prepare_openwebtext.py`` writes them)
  --data_format enwik8        byte-level random crops (the easy-transformer configs)
  --data_format packed        LITPKDS chunk dirs (``scripts/prepare_packed.py``): the C++
                              reader of ``native/`` trains (the numpy reader, with a
                              warning, where g++ is missing), ``PackedDataset`` validates

``attn_alg`` selects the fork's attention algorithm; with ``fastmax`` or
``fastmax_cuda`` every attention call of a step goes through the fastmax
kernels K4/K5 on the card at head sizes up to 64 and through the reversible
float32 scan above; ``linearmax`` and ``performer`` run their chunked scans
(``ops/fastmax.py``). The torch train state (``out_dir/state/train_state.pt``)
is saved every ``save_interval`` steps and at the end, and ``io.resume``
continues from it (the reference's resume format is orbax's; the two do not
read each other's). At the end the deploy checkpoint is written as the
reference writes it: ``out_dir/final`` in the npy layout
(``utils/checkpoint.py``) with ``out_dir/final/lit_config.json``.
``logger_name`` is csv, tensorboard or wandb (``utils/logging.py``).

``dp``/``fsdp``/``tp`` (the reference's pretrain.py:125-143) train on a
(data, fsdp, model) mesh of ``dp * fsdp * tp`` ranks, one process each under
``torchrun`` (started alone it raises, naming the line): every rank builds
the same model from ``seed``, keeps its shards (``shard_params(...,
train=True)``), draws the same global micro-batches and trains its rows of
them (``fit``'s ``mesh``). The train state is saved whole by rank 0 and
resumes at any mesh; the deploy checkpoint and ``lit_config.json`` are
written whole by rank 0.

The command line is the reference's (``utils/cli.py``); on the card
(``--device cpu`` for the CPU):

    python -m fastmax_tpu_torch.training.pretrain --model_name easy-transformer-fastmax \\
        --data_format enwik8 --io.train_data_dir data/enwik8.gz --io.out_dir out
    torchrun --nproc_per_node 4 -m fastmax_tpu_torch.training.pretrain --dp 2 --fsdp 2 ...
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.lm_datasets import Enwik8Dataset, MemmapDataset
from ..data.packed_dataset import PackedDataset, batch_iterator
from ..inference.engine import default_device
from ..models import gpt
from ..models.config import Config
from ..models.params import params_to_flat
from ..native.loader import NativePackedDataset
from ..parallel.sharding import train_mesh_from_env
from ..utils.args import EvalArgs, IOArgs, TrainArgs
from ..utils.checkpoint import save_flat_checkpoint
from ..utils.logging import choose_logger
from .fit import (TrainState, build_optimizer, fit, has_train_state, load_train_state,
                  save_train_state, shard_train_state, whole_params)
from .step import tree_leaves


def _token_dtype(data_dir: Path) -> str:
    meta = data_dir / "meta.json"
    return json.loads(meta.read_text()).get("dtype", "uint16") if meta.is_file() else "uint16"


def data_iterators(data_format: str, io: IOArgs, block_size: int, batch_size: int, seed: int = 0):
    if data_format == "openwebtext":
        data_dir = Path(io.train_data_dir)
        train_ds = MemmapDataset(data_dir / "train.bin", block_size, seed,
                                 dtype=getattr(np, _token_dtype(data_dir)))
        val_dir = Path(io.val_data_dir or io.train_data_dir)
        val_path = val_dir / "val.bin"
        val_ds = (MemmapDataset(val_path, block_size, seed + 1,
                                dtype=getattr(np, _token_dtype(val_dir)))
                  if val_path.exists() else None)
    elif data_format == "enwik8":
        src = Path(io.train_data_dir)
        src = src / "enwik8.gz" if src.is_dir() else src
        train_ds = Enwik8Dataset(src, block_size, "train", seed)
        val_ds = Enwik8Dataset(src, block_size, "val", seed + 1)
    elif data_format == "packed":
        files = sorted(Path(io.train_data_dir).glob("*.bin"))
        if not files:
            raise FileNotFoundError(f"no .bin chunks under {io.train_data_dir}")
        # the C++ prefetch-threaded reader (native/), built at first use
        train_ds = NativePackedDataset(files, block_size + 1, seed=seed, wrap=True)
        val_ds = None
        if io.val_data_dir:
            vfiles = sorted(Path(io.val_data_dir).glob("*.bin"))
            val_ds = PackedDataset(vfiles, n_chunks=min(2, len(vfiles)),
                                   block_size=block_size + 1, seed=seed + 1, wrap=True)
    else:
        raise ValueError(f"unknown data_format {data_format!r}")
    train_iter = batch_iterator(train_ds, batch_size)
    val_iter_fn = (lambda: batch_iterator(val_ds, batch_size)) if val_ds is not None else None
    return train_iter, val_iter_fn


def setup(
    model_name: str = "easy-transformer",
    data_format: str = "openwebtext",
    attn_alg: Optional[str] = None,
    logger_name: str = "csv",
    seed: int = 1337,
    dtype: str = "float32",
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    train: TrainArgs = TrainArgs(
        global_batch_size=8, micro_batch_size=4, max_iters=100, learning_rate=6e-4,
        save_interval=1000, log_interval=10,
    ),
    eval: EvalArgs = EvalArgs(interval=50, max_iters=20),
    io: IOArgs = IOArgs(),
    device=None,
) -> TrainState:
    """Train ``model_name`` from scratch on the card (``device="cpu"`` for the
    CPU); resume from ``out_dir/state`` with ``io.resume``. Logs to
    ``out_dir/metrics.csv`` and returns the final TrainState (on a mesh, the
    rank's shards)."""
    mesh = train_mesh_from_env(dp, fsdp, tp, "fastmax_tpu_torch.training.pretrain",
                               train.micro_batch_size)
    leader = mesh is None or mesh.leader
    device = default_device(device)
    cfg = Config.from_name(model_name, **({"attn_alg": attn_alg} if attn_alg else {}))
    if train.max_seq_length:
        cfg.block_size = min(cfg.block_size, train.max_seq_length)

    out_dir = Path(io.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = choose_logger(logger_name, out_dir) if leader else None

    optimizer = build_optimizer(train)
    ckpt_dir = out_dir / "state"
    if io.resume and has_train_state(ckpt_dir):
        state = load_train_state(ckpt_dir, device)
        print(f"resumed at step {state.step}")
    else:
        params = gpt.init_params(cfg, seed, getattr(torch, dtype), device)
        state = TrainState(params, optimizer.init(params))
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, attn_alg={cfg.attn_alg}")
    if mesh is not None:
        state = shard_train_state(state, mesh, cfg, optimizer)
        print(f"mesh: dp={dp} fsdp={fsdp} tp={tp}")

    train_iter, val_iter_fn = data_iterators(
        data_format, io, cfg.block_size, train.micro_batch_size, seed)

    t0 = time.perf_counter()
    state = fit(cfg, state, optimizer, train_iter, train=train, eval_args=eval,
                val_iter_fn=val_iter_fn, logger=logger,
                checkpoint_fn=lambda s: save_train_state(s, ckpt_dir, optimizer), mesh=mesh)
    print(f"done: {state.step} steps in {time.perf_counter()-t0:.1f}s")

    # deploy checkpoint (weights only, the reference's lit-format contract)
    whole = whole_params(state.params)
    if leader:
        save_flat_checkpoint(params_to_flat(whole, cfg), out_dir / "final")
        cfg.to_json(out_dir / "final" / "lit_config.json")
        logger.finalize()
    return state


def main(args=None) -> TrainState:
    """The command line: ``setup``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    return CLI(setup, args)


if __name__ == "__main__":
    main()
