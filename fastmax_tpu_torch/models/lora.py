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
the JAX package's LoRA leaves over instead. ``merge_lora`` folds the deltas
into dense, int8 and packed 4-bit bases (dequantize, add, requantize).
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
        elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
            mlp["fc_1"].update(stacked_lora(cfg.n_embd, cfg.intermediate_size))
            mlp["fc_2"].update(stacked_lora(cfg.n_embd, cfg.intermediate_size))
            mlp["proj"].update(stacked_lora(cfg.intermediate_size, cfg.n_embd))
        elif cfg.mlp_class_name == "LLaMAMoE":  # the router; the experts stay as they are
            mlp["gate"].update(stacked_lora(cfg.n_embd, cfg.n_expert))
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


def _lora_delta(p: dict) -> torch.Tensor:
    """(A @ B) * scale [* mask] in f32, summed over the rank in order, a
    product then a sum (as numpy's einsum does), so that the merge is the
    reference's bit for bit."""
    a, b = p["lora_A"].float(), p["lora_B"].float()
    lead = tuple(a.shape[:-2])
    delta = a[..., :, 0, None] * b[..., 0, None, :]
    for i in range(1, a.shape[-1]):
        delta = delta + a[..., :, i, None] * b[..., i, None, :]
    delta = delta * p["lora_scale"].float().reshape(lead + (1, 1))
    if "lora_mask" in p:
        delta = delta * p["lora_mask"].float()[..., None, :]
    return delta


def _quant_mode(p: dict) -> str:
    """The ``quantize_model`` mode of a quantized linear: "bnb.int8" for q8,
    else its codebook (matched against ``quant.CODEBOOKS``), "-dq" when its
    scales are double-quantized."""
    from ..ops import quant

    if "q8" in p:
        return "bnb.int8"
    if "q4" not in p:
        raise NotImplementedError(f"merging LoRA into a {sorted(p)} linear: only dense, int8 "
                                  "and packed 4-bit bases merge, as in the reference")
    code = np.sort(p["code"].detach().float().cpu().numpy().reshape(-1, 16)[0])
    kind = next((name for name, table in quant.CODEBOOKS.items()
                 if np.allclose(code, np.sort(table))), "nf4")
    mode = {"nf4": "bnb.nf4", "fp4": "bnb.fp4", "int4": "gptq.int4"}[kind]
    return mode + "-dq" if "absmax_q" in p and mode.startswith("bnb") else mode


def merge_lora(params: dict, cfg: Optional[Config] = None) -> dict:
    """Fold every LoRA delta into its base weight and drop the LoRA leaves.

    A dense kernel takes the delta in f32, then its own dtype. A quantized
    base (int8, or 4-bit with its codebook and scales, double-quantized or
    not) is dequantized, merged and requantized in its own mode, one layer
    at a time where its leaves are stacked, on its device; its bias stays."""
    from ..ops import quant

    def merge_linear(p: dict) -> dict:
        if "lora_A" not in p:
            return p
        delta = _lora_delta(p)
        out = {k: v for k, v in p.items() if not k.startswith("lora_")}
        if "kernel" in p:
            out["kernel"] = (p["kernel"].float() + delta).to(p["kernel"].dtype)
            return out
        mode = _quant_mode(p)
        lead = tuple(p["lora_A"].shape[:-2])
        base = {k: v for k, v in out.items() if k != "bias"}
        slices = []
        for idx in np.ndindex(*lead):
            part = {k: v[idx] if v.ndim > quant._RANK.get(k, 0) else v for k, v in base.items()}
            slices.append(quant.quantize_linear_params(
                {"kernel": quant.dequantize(part, torch.float32) + delta[idx]}, mode))
        q = {k: torch.stack([s[k] for s in slices]).reshape(lead + tuple(slices[0][k].shape))
             for k in slices[0]}
        if "bias" in p:
            q["bias"] = p["bias"]
        return q

    def walk(node):
        if isinstance(node, dict):
            return merge_linear(node) if "lora_A" in node else {k: walk(v)
                                                                for k, v in node.items()}
        return node

    return {k: walk(v) for k, v in params.items()}
