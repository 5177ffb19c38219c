"""LoRA as extra leaves of a linear's parameter dict (counterpart of
``fastmax_tpu/models/lora.py``).

A linear with LoRA holds, beside its base weight (dense or quantized),

  {"lora_A": (in, r), "lora_B": (r, out), "lora_scale": () f32, ["lora_mask": (out,)]}

and ``ops/linear.linear`` adds ``((x @ A) @ B) * scale * mask``. On the fused
QKV projection the per-projection flags become a 0/1 mask over its output
features in the grouped layout [per group: q x q_per_kv | k | v]. Block
leaves stack on the (n_layer,) axis like the base weights. Only ``lora_A``
and ``lora_B`` train (``trainable_mask``). The numbers of ``lora_A`` come
from a ``torch.Generator`` and differ from the JAX package's; tests bring
the JAX package's LoRA leaves over instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import Config


@dataclass
class LoRAConfig:
    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    query: bool = True
    key: bool = False
    value: bool = True
    projection: bool = False
    mlp: bool = False
    head: bool = False


def qkv_enable_mask(cfg: Config, lora: LoRAConfig) -> np.ndarray:
    """0/1 over the fused QKV output features in the grouped layout."""
    q_per_kv = cfg.n_head // cfg.n_query_groups
    hs = cfg.head_size
    group = np.concatenate([np.full(q_per_kv * hs, 1.0 if lora.query else 0.0),
                            np.full(hs, 1.0 if lora.key else 0.0),
                            np.full(hs, 1.0 if lora.value else 0.0)])
    return np.tile(group, cfg.n_query_groups).astype(np.float32)


def _init_lora(gen: torch.Generator, n_in: int, n_out: int, lora: LoRAConfig, dtype, device,
               mask=None) -> dict:
    """A ~ kaiming-uniform (bound sqrt(3 / n_in)), B = 0."""
    bound = float(np.sqrt(3.0) * np.sqrt(1.0 / n_in))
    a = torch.empty((n_in, lora.r), device=device).uniform_(-bound, bound, generator=gen)
    extra = {"lora_A": a.to(dtype),
             "lora_B": torch.zeros((lora.r, n_out), dtype=dtype, device=device),
             "lora_scale": torch.tensor(lora.alpha / lora.r, dtype=torch.float32, device=device)}
    if mask is not None:
        extra["lora_mask"] = torch.as_tensor(mask, device=device).to(dtype)
    return extra


def add_lora_params(params: dict, cfg: Config, lora: LoRAConfig, gen: torch.Generator,
                    dtype=torch.float32) -> dict:
    """params with LoRA leaves added to the selected linears (a new tree; the
    base tensors are shared, not copied). Each layer draws its own lora_A
    from ``gen``, which must live on the parameters' device."""
    device = params["wte"].device
    L = cfg.n_layer

    def copy(node):
        return {k: copy(v) for k, v in node.items()} if isinstance(node, dict) else node

    out = copy(params)

    def stacked_lora(n_in, n_out, mask=None):
        per_layer = [_init_lora(gen, n_in, n_out, lora, dtype, device, mask) for _ in range(L)]
        return {k: torch.stack([p[k] for p in per_layer]) for k in per_layer[0]}

    blocks = out["blocks"]
    if lora.query or lora.key or lora.value:
        blocks["attn"]["attn"].update(
            stacked_lora(cfg.n_embd, cfg.qkv_shape, qkv_enable_mask(cfg, lora)))
    if lora.projection:
        blocks["attn"]["proj"].update(stacked_lora(cfg.head_size * cfg.n_head, cfg.n_embd))
    if lora.mlp:
        mlp = blocks["mlp"]
        if cfg.mlp_class_name == "GptNeoxMLP":
            mlp["fc"].update(stacked_lora(cfg.n_embd, cfg.intermediate_size))
            mlp["proj"].update(stacked_lora(cfg.intermediate_size, cfg.n_embd))
        elif cfg.mlp_class_name == "LLaMAMLP":
            mlp["fc_1"].update(stacked_lora(cfg.n_embd, cfg.intermediate_size))
            mlp["fc_2"].update(stacked_lora(cfg.n_embd, cfg.intermediate_size))
            mlp["proj"].update(stacked_lora(cfg.intermediate_size, cfg.n_embd))
        else:
            raise NotImplementedError(f"LoRA on the {cfg.mlp_class_name} MLP is not ported yet")
    if lora.head:
        out["lm_head"].update(_init_lora(gen, cfg.n_embd, cfg.padded_vocab_size, lora, dtype,
                                         device))
    return out


def trainable_mask(params: dict) -> dict:
    """True for the lora_A and lora_B leaves only."""
    return {k: trainable_mask(v) if isinstance(v, dict) else k in ("lora_A", "lora_B")
            for k, v in params.items()}


def lora_filter_flat(name: str) -> bool:
    """Checkpoint filter: keep only LoRA tensors."""
    return "lora_" in name


def split_lora_state(params: dict):
    """(base, lora_only) trees for LoRA-only checkpoints."""
    def walk(node):
        lora, base = {}, {}
        for k, v in node.items():
            if isinstance(v, dict):
                sub_l, sub_b = walk(v)
                if sub_l:
                    lora[k] = sub_l
                if sub_b:
                    base[k] = sub_b
            elif k.startswith("lora_"):
                lora[k] = v
            else:
                base[k] = v
        return lora, base

    lora, base = walk(params)
    return base, lora


def merge_lora(params: dict, cfg: Optional[Config] = None) -> dict:
    """Fold every LoRA delta into its dense base kernel (in f32, then the
    kernel's dtype) and drop the LoRA leaves. A quantized base (dequantize,
    add, requantize in the reference) is not ported yet."""
    def merge_linear(p: dict) -> dict:
        if "lora_A" not in p:
            return p
        if "kernel" not in p:
            raise NotImplementedError("merging LoRA into a quantized base is not ported yet "
                                      "(ROADMAP queue A, item 7)")
        a, b = p["lora_A"].float(), p["lora_B"].float()
        lead = tuple(a.shape[:-2])
        delta = torch.matmul(a, b) * p["lora_scale"].float().reshape(lead + (1, 1))
        if "lora_mask" in p:
            delta = delta * p["lora_mask"].float()[..., None, :]
        out = {k: v for k, v in p.items() if not k.startswith("lora_")}
        out["kernel"] = (p["kernel"].float() + delta).to(p["kernel"].dtype)
        return out

    def walk(node):
        if isinstance(node, dict):
            return merge_linear(node) if "lora_A" in node else {k: walk(v)
                                                                for k, v in node.items()}
        return node

    return {k: walk(v) for k, v in params.items()}
