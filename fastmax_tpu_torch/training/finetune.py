"""Finetuning recipe (counterpart of ``fastmax_tpu/training/finetune.py``):
``method`` "lora" or "full", on a dense base or, with ``quantize`` "bnb.nf4"
or "bnb.nf4-dq", on an NF4 base that stays frozen (QLoRA: the reference's
finetune/lora.py flow).

``setup`` builds the model from the registry (random weights from ``seed``),
quantizes it, adds the LoRA leaves, and trains with ``sft_loss_fn``
(``gpt.forward_hidden`` under per-block remat + ``chunked_cross_entropy``
with the lm_head in chunks of 128) through ``fit`` and the masked AdamW:
only lora_A/lora_B require grad. With ``attn_alg="quadratic"`` every layer
at T >= 1024 takes the trainable flash kernels K6/K7 on the card. LoRA runs
save the LoRA leaves to ``out_dir/lora_weights.safetensors`` by their tree
paths ("blocks.attn.attn.lora_A", ...), as the reference does; ``full``
saves the torch train state in ``out_dir/state`` (the lit-format checkpoint
waits for ROADMAP item 7).

Not ported yet, each raising ``NotImplementedError``: ``checkpoint_dir``
(the lit-format loader, ROADMAP queue A item 7), ``adapter``/``adapter_v2``
(item 4), ``gptq_calib`` and the quantize modes other than bnb.nf4 and
bnb.nf4-dq (item 3), ``dp``/``fsdp``/``tp`` above 1 (item 8).

Example (the card; pass device="cpu" to run on the CPU):

    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.utils.args import TrainArgs
    finetune.setup(method="lora", model_name="Llama-2-7b-hf", quantize="bnb.nf4",
                   attn_alg="quadratic", precision="bfloat16", data_path="train.npz",
                   train=TrainArgs(global_batch_size=8, micro_batch_size=2, max_iters=100,
                                   learning_rate=3e-4, max_seq_length=2048))
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from ..data.lm_datasets import SFTDataset
from ..inference.engine import default_device
from ..models import gpt
from ..models import lora as lora_mod
from ..models.config import Config
from ..ops.quant import quantize_model
from ..utils.args import EvalArgs, IOArgs, TrainArgs
from ..utils.checkpoint import save_flat_checkpoint
from ..utils.logging import choose_logger
from ..utils.loss import chunked_cross_entropy
from .fit import TrainState, build_optimizer, fit, save_train_state
from .step import tree_leaves

METHODS = ("full", "lora", "adapter", "adapter_v2")


def sft_loss_fn(cfg: Config, remat=True, lm_head_chunk_size: int = 128, plain: bool = False):
    """loss_fn(params, (inputs, labels)): hidden[:, :-1] predicts labels[:, 1:],
    the lm_head and the loss ``lm_head_chunk_size`` positions at a time."""
    def loss_fn(params, batch):
        inputs, labels = batch
        hidden = gpt.forward_hidden(params, cfg, inputs, remat=remat, plain=plain)
        return chunked_cross_entropy(hidden[:, :-1], params["lm_head"], labels[:, 1:],
                                     lm_head_chunk_size)

    return loss_fn


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        flat.update(_flatten(v, name) if isinstance(v, dict) else {name: v})
    return flat


def setup(
    method: str = "lora",
    checkpoint_dir: Optional[Path] = None,
    model_name: Optional[str] = None,
    data_path: Optional[Path] = None,
    quantize: Optional[str] = None,
    gptq_calib: bool = False,
    attn_alg: Optional[str] = None,
    precision: str = "float32",
    logger_name: str = "csv",
    seed: int = 1337,
    lora_r: int = 8,
    lora_alpha: float = 16.0,
    lora_query: bool = True,
    lora_key: bool = False,
    lora_value: bool = True,
    lora_projection: bool = False,
    lora_mlp: bool = False,
    lora_head: bool = False,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    train: TrainArgs = TrainArgs(
        global_batch_size=8, micro_batch_size=2, max_iters=100, learning_rate=3e-4,
        save_interval=1000, log_interval=10, max_seq_length=512,
    ),
    eval: EvalArgs = EvalArgs(interval=100, max_iters=20),
    io: IOArgs = IOArgs(),
    device=None,
) -> TrainState:
    """Finetune ``model_name`` on the SFT examples at ``data_path`` on the card
    (``device="cpu"`` for the CPU). Logs to ``out_dir/metrics.csv`` and
    returns the final TrainState."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if method != "lora" and method != "full":
        raise NotImplementedError(f"method {method!r} (models/adapter.py) is not ported yet "
                                  "(ROADMAP queue A, item 4)")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint_dir: the lit-format checkpoint loader is not "
                                  "ported yet (ROADMAP queue A, item 7); pass model_name")
    if gptq_calib:
        raise NotImplementedError("gptq_calib (ops/gptq.py) is not ported yet (ROADMAP queue "
                                  "A, item 3)")
    if dp * fsdp * tp > 1:
        raise NotImplementedError("dp/fsdp/tp > 1 come with the multi-GPU item (ROADMAP "
                                  "queue A, item 8)")
    if quantize is not None and method == "full":
        raise ValueError("full finetuning of quantized weights is not supported")
    device = default_device(device)
    dtype = getattr(torch, precision)

    cfg = Config.from_name(model_name, **({"attn_alg": attn_alg} if attn_alg else {}))
    params = gpt.init_params(cfg, seed, dtype, device)
    if quantize:
        params = quantize_model(params, quantize)

    trainable = None
    if method == "lora":
        lcfg = lora_mod.LoRAConfig(r=lora_r, alpha=lora_alpha, query=lora_query, key=lora_key,
                                   value=lora_value, projection=lora_projection, mlp=lora_mlp,
                                   head=lora_head)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        params = lora_mod.add_lora_params(params, cfg, lcfg, gen, dtype)
        trainable = lora_mod.trainable_mask(params)
    leaves = tree_leaves(params)
    n_all = sum(p.numel() for p in leaves)
    n_train = n_all if trainable is None else sum(
        p.numel() for p, m in zip(leaves, tree_leaves(trainable)) if m)
    print(f"{method}: {n_train/1e6:.2f}M trainable of {n_all/1e6:.1f}M")

    ds = SFTDataset.load(Path(data_path), seed)
    train_iter = ds.batches(train.micro_batch_size, train.max_seq_length)
    out_dir = Path(io.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = choose_logger(logger_name, out_dir)

    optimizer = build_optimizer(train, trainable)
    state = TrainState(params, optimizer.init(params))

    def checkpoint_fn(s: TrainState) -> None:
        if method == "full":
            save_train_state(s, out_dir / "state")
            return
        _, delta = lora_mod.split_lora_state(s.params)
        save_flat_checkpoint(_flatten(delta), out_dir / f"{method}_weights.safetensors")

    state = fit(cfg, state, optimizer, train_iter, train=train, eval_args=eval, val_iter_fn=None,
                logger=logger, loss_fn=sft_loss_fn(cfg), checkpoint_fn=checkpoint_fn,
                trainable=trainable)
    logger.finalize()
    print(f"finetune done at step {state.step}; weights in {out_dir}")
    return state
