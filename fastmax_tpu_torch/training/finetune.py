"""Finetuning recipe (counterpart of ``fastmax_tpu/training/finetune.py``):
``method`` "lora", "adapter", "adapter_v2" or "full", on a dense base or,
with ``quantize`` one of ``ops.quant.QUANT_MODES`` ("bnb.nf4", "bnb.nf4-dq",
...), on a quantized base that stays frozen (QLoRA: the reference's
finetune/lora.py flow; the adapters' finetune/adapter*.py).

``setup`` takes the base from ``checkpoint_dir`` (a converted checkpoint
directory: ``lit_config.json`` and the weights, read by
``utils/checkpoint.load_model_params`` in ``precision`` on the device, one
tensor at a time) or builds ``model_name`` from the registry with random
weights from ``seed``; quantizes it, adds the LoRA or adapter leaves
(``models/lora.py``, ``models/adapter.py``), and trains with ``sft_loss_fn``
(``gpt.forward_hidden`` under per-block remat + ``chunked_cross_entropy``
with the lm_head in chunks of 128) through ``fit`` and the masked optimizer
of ``--train.optimizer`` (adamw, adamw8bit, adafactor, lion): only the
method's trainable leaves require grad. With ``attn_alg="quadratic"`` every
layer at T >= 1024 takes the trainable flash kernels K6/K7 on the card; the
fork's linear arms train at every head size (``ops/fastmax.py``): ``fastmax``
and ``fastmax_cuda`` at a head size of 128 (Llama-2-7B) run the reversible
float32 scan in head groups, ``linearmax`` and ``performer`` their chunked
scans, each in float32 and cast back to a bf16 model's type. LoRA runs save
the LoRA leaves to ``out_dir/lora_weights.safetensors`` by their tree paths
("blocks.attn.attn.lora_A", ...), adapter runs the leaves that
``adapter.adapter_filter_flat`` keeps to ``out_dir/<method>_weights.
safetensors`` by the same kind of names, ``full`` runs the whole model to
``out_dir/full_weights.safetensors`` by its lit-gpt names
(``models/params.params_to_flat``), as the reference does.

The command line is the reference's (``utils/cli.py``), so a launch script's
flags run here unchanged, on the card (``--device cpu`` for the CPU):

    python -m fastmax_tpu_torch.training.finetune --method lora --quantize bnb.nf4 \\
        --attn_alg quadratic --checkpoint_dir checkpoints/meta-llama/Llama-2-7b-hf \\
        --data_path data/alpaca/train.npz --precision bfloat16 \\
        --train.micro_batch_size 2 --train.max_seq_length 512 --io.out_dir out/qlora

With ``gptq_calib`` and a 4-bit ``quantize`` mode the base is quantized by
GPTQ (``ops/gptq.py``, on the device) against four examples of the training
data, as the reference does; other modes round to nearest.

``dp``/``fsdp``/``tp`` (the reference's finetune.py:173-214) train on a
(data, fsdp, model) mesh under ``torchrun`` (started alone it raises, naming
the line), as ``pretrain`` does: each rank builds the base, quantizes it and
adds the method's leaves from the same seed, then keeps its shards. A quantized
base's codes are cut and gathered, never differentiated; LoRA and adapter
leaves keep their linear whole over ``model`` (``ShardPlan.kept_whole``), so
their gradients are summed over data x fsdp only. The delta files are gathered
whole and written by rank 0:

    torchrun --nproc_per_node 4 -m fastmax_tpu_torch.training.finetune --fsdp 2 --tp 2 ...
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from ..data.lm_datasets import SFTDataset
from ..inference.engine import default_device
from ..models import adapter as adapter_mod
from ..models import gpt
from ..models import lora as lora_mod
from ..models.config import Config
from ..models.params import params_to_flat
from ..ops.gptq import FOUR_BIT_KINDS, gptq_quantize_model
from ..ops.quant import quantize_model
from ..parallel.sharding import shard_params, train_mesh_from_env
from ..utils.args import EvalArgs, IOArgs, TrainArgs
from ..utils.checkpoint import load_model_params, save_flat_checkpoint
from ..utils.logging import choose_logger
from ..utils.loss import chunked_cross_entropy
from .fit import TrainState, build_optimizer, fit, whole_params
from .step import tree_leaves

METHODS = ("full", "lora", "adapter", "adapter_v2")


def sft_loss_fn(cfg: Config, remat=True, lm_head_chunk_size: int = 128, plain: bool = False,
                shard=None):
    """loss_fn(params, (inputs, labels)): hidden[:, :-1] predicts labels[:, 1:],
    the lm_head and the loss ``lm_head_chunk_size`` positions at a time.
    ``shard``: the masked mean over the global batch, its gradient the rank's
    share (the SFT rows carry different numbers of ignored labels)."""
    def loss_fn(params, batch):
        inputs, labels = batch
        hidden = gpt.forward_hidden(params, cfg, inputs, remat=remat, plain=plain, shard=shard)
        if shard is None:
            return chunked_cross_entropy(hidden[:, :-1], params["lm_head"], labels[:, 1:],
                                         lm_head_chunk_size)
        total, count = chunked_cross_entropy(
            hidden[:, :-1], None, labels[:, 1:], lm_head_chunk_size,
            logits_fn=gpt.lm_head_fn(params, shard), parts=True)
        return shard.global_mean(total, count)

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
    adapter_prompt_length: int = 10,
    adapter_start_layer: int = 2,
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
    """Finetune the model of ``checkpoint_dir`` (or ``model_name``) on the SFT
    examples at ``data_path`` on the card (``device="cpu"`` for the CPU). Logs
    to ``out_dir/metrics.csv`` and returns the final TrainState."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    if quantize is not None and method == "full":
        raise ValueError("full finetuning of quantized weights is not supported")
    mesh = train_mesh_from_env(dp, fsdp, tp, "fastmax_tpu_torch.training.finetune",
                               train.micro_batch_size)
    leader = mesh is None or mesh.leader
    device = default_device(device)
    dtype = getattr(torch, precision)

    kw = {"attn_alg": attn_alg} if attn_alg else {}
    if checkpoint_dir is not None:
        cfg = Config.from_checkpoint(Path(checkpoint_dir), **kw)
        _, params = load_model_params(Path(checkpoint_dir), cfg, dtype, device)
    else:
        cfg = Config.from_name(model_name, **kw)
        params = gpt.init_params(cfg, seed, dtype, device)
    if quantize:
        if gptq_calib and quantize in FOUR_BIT_KINDS and data_path is not None:
            # GPTQ the base against the training distribution itself: the frozen
            # weights only ever meet activations of this data (ops/gptq.py)
            calib, _ = SFTDataset.load(Path(data_path), seed).sample_batch(
                4, min(train.max_seq_length or cfg.block_size, cfg.block_size))
            params = gptq_quantize_model(params, cfg, calib, kind=FOUR_BIT_KINDS[quantize],
                                         double_quant=quantize.endswith("-dq"), device=device)
        else:
            params = quantize_model(params, quantize)

    trainable = None
    if method == "lora":
        lcfg = lora_mod.LoRAConfig(r=lora_r, alpha=lora_alpha, query=lora_query, key=lora_key,
                                   value=lora_value, projection=lora_projection, mlp=lora_mlp,
                                   head=lora_head)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        params = lora_mod.add_lora_params(params, cfg, lcfg, gen, dtype)
        trainable = lora_mod.trainable_mask(params)
    elif method in ("adapter", "adapter_v2"):
        acfg = adapter_mod.AdapterConfig(adapter_prompt_length, adapter_start_layer)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        v2 = method == "adapter_v2"
        params = adapter_mod.add_adapter_params(params, cfg, acfg, gen, dtype, v2=v2)
        trainable = adapter_mod.trainable_mask(params, v2=v2)
    leaves = tree_leaves(params)
    n_all = sum(p.numel() for p in leaves)
    n_train = n_all if trainable is None else sum(
        p.numel() for p, m in zip(leaves, tree_leaves(trainable)) if m)
    print(f"{method}: {n_train/1e6:.2f}M trainable of {n_all/1e6:.1f}M")

    ds = SFTDataset.load(Path(data_path), seed)
    train_iter = ds.batches(train.micro_batch_size, train.max_seq_length)
    out_dir = Path(io.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = choose_logger(logger_name, out_dir) if leader else None

    plan = None
    if mesh is not None:
        params = shard_params(params, mesh, cfg, train=True)
        plan = params.plan
        print(f"mesh: dp={dp} fsdp={fsdp} tp={tp}; kept whole over model: "
              f"{list(plan.kept_whole)}")
    optimizer = build_optimizer(train, trainable)
    splits = None if plan is None else plan.leaf_splits(tree_leaves(params))
    state = TrainState(params, optimizer.init(params, splits))

    def checkpoint_fn(s: TrainState) -> None:
        if method == "full":
            flat = params_to_flat(whole_params(s.params), cfg)
        else:
            if method == "lora":
                flat = _flatten(lora_mod.split_lora_state(s.params)[1])
            else:
                flat = {k: v for k, v in _flatten(s.params).items()
                        if adapter_mod.adapter_filter_flat(k, v2=method == "adapter_v2")}
            if plan is not None:  # the leaves named, gathered whole
                with torch.no_grad():
                    flat = {k: plan.leaf_split(tuple(k.split(".")), v).gather(v)
                            for k, v in flat.items()}
        if leader:
            save_flat_checkpoint(flat, out_dir / f"{method}_weights.safetensors")

    state = fit(cfg, state, optimizer, train_iter, train=train, eval_args=eval, val_iter_fn=None,
                logger=logger, loss_fn=sft_loss_fn(cfg, shard=plan), checkpoint_fn=checkpoint_fn,
                trainable=trainable, mesh=mesh)
    if leader:
        logger.finalize()
    print(f"finetune done at step {state.step}; weights in {out_dir}")
    return state


def main(args=None) -> TrainState:
    """The command line: ``setup``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    return CLI(setup, args)


if __name__ == "__main__":
    main()
