"""Parameter tree <-> flat lit-gpt-named state dict (counterpart of
``fastmax_tpu/models/params.py``).

The on-disk checkpoint contract is the reference's: a flat mapping of
``transformer.h.{i}.attn.attn.weight``-style names to (out, in)-layout
tensors (what ``lit_model.pth`` holds and ``scripts/convert_hf_checkpoint.py``
writes). The port's tree has the JAX tree's layout (``models/weights.py``):

* kernels in (in, out) layout, the ``x @ W`` orientation,
* block leaves stacked on a leading (n_layer,) axis,
* MoE expert kernels stacked on (n_layer, n_expert), as
  ``models/gpt.apply_moe`` reads them.

These two functions are the only place the naming/layout translation lives.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..utils.checkpoint import to_tensor
from .config import Config


def params_to_flat(params: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """The tree as a flat lit-gpt-named dict. The values are detached views of
    the tree's leaves, on their device (kernels transposed, so not
    contiguous): a writer moves them to the host one at a time."""
    out: Dict[str, torch.Tensor] = {}
    out["transformer.wte.weight"] = params["wte"].detach()
    out["lm_head.weight"] = params["lm_head"]["kernel"].detach().T
    if "bias" in params["lm_head"]:
        out["lm_head.bias"] = params["lm_head"]["bias"].detach()
    for k, v in params["ln_f"].items():
        out[f"transformer.ln_f.{k}"] = v.detach()

    def emit(prefix: str, sub: dict, layer: int):
        for name, leaf in sub.items():
            if isinstance(leaf, dict):
                emit(f"{prefix}.{name}", leaf, layer)
            elif name == "kernel":
                out[f"{prefix}.weight"] = leaf[layer].detach().T
            else:  # bias / norm weight
                out[f"{prefix}.{name}"] = leaf[layer].detach()

    for i in range(cfg.n_layer):
        for name, sub in params["blocks"].items():
            if name == "mlp" and cfg.mlp_class_name == "LLaMAMoE":
                out[f"transformer.h.{i}.mlp.gate.weight"] = sub["gate"]["kernel"][i].detach().T
                for e in range(cfg.n_expert):
                    for lin_name, lin in sub["experts"].items():
                        prefix = f"transformer.h.{i}.mlp.experts.{e}.{lin_name}"
                        out[f"{prefix}.weight"] = lin["kernel"][i, e].detach().T
                        if "bias" in lin:
                            out[f"{prefix}.bias"] = lin["bias"][i, e].detach()
            elif isinstance(sub, dict):
                emit(f"transformer.h.{i}.{name}", sub, i)
    return out


def flat_to_params(flat, cfg: Config, dtype=torch.float32, device=None, *,
                   leaf_get=None, leaf_stack=None) -> dict:
    """Build the tree from a flat lit-gpt-named dict of tensors (torch, or
    numpy as the JAX package gives them) on ``device`` (default: the card) in
    ``dtype``. A stacked leaf is allocated whole on the device and filled one
    layer (and expert) at a time: each source tensor is copied to the device
    as it lies in the file and transposed and cast there, so with lazy sources
    (``utils/checkpoint.load_flat_checkpoint``) the host holds no copy of the
    model and the device one layer's source beside the tree.

    ``leaf_get(source, transpose)`` and ``leaf_stack(leaves, lead)`` replace
    how a leaf is made from its stored tensor and how leaves are stacked
    (``utils/sharded_load.py`` builds a tree of lazy leaves with them; dtype
    and device are then unused)."""
    if leaf_get is not None:
        return _build_tree(flat, cfg, lambda name, tr: leaf_get(flat[name], tr),
                           lambda names, tr, lead=None: leaf_stack(
                               [leaf_get(flat[n], tr) for n in names], lead))

    from ..inference.engine import default_device

    device = default_device(device)

    def source(name: str, transpose: bool) -> torch.Tensor:
        """``name``'s tensor on the device in its own type and layout (a copy of
        the file's contiguous bytes), transposed as a view there."""
        t = to_tensor(flat[name]).to(device)
        return t.T if transpose else t

    def get(name: str, transpose: bool = False) -> torch.Tensor:
        t = source(name, transpose)
        return torch.empty(t.shape, dtype=dtype, device=device).copy_(t)

    def stacked(names: List[str], transpose: bool, lead=None) -> torch.Tensor:
        """The tensors of ``names`` stacked on ``lead`` (default: (len(names),)),
        in row-major order."""
        shape = to_tensor(flat[names[0]]).shape
        shape = shape[::-1] if transpose else shape
        out = torch.empty(tuple(lead or (len(names),)) + tuple(shape), dtype=dtype, device=device)
        rows = out.view(-1, *shape)
        for j, name in enumerate(names):
            rows[j].copy_(source(name, transpose))
        return out

    return _build_tree(flat, cfg, get, stacked)


def _build_tree(flat, cfg: Config, get: Callable, stacked: Callable) -> dict:
    """The tree's layout over the flat names: ``get(name, transpose)`` makes a
    leaf, ``stacked(names, transpose, lead)`` one stacked on ``lead``."""
    def has(name: str) -> bool:
        return name in flat

    def layers(fn: Callable[[int], str]) -> List[str]:
        return [fn(i) for i in range(cfg.n_layer)]

    def linear_of(prefix_fn: Callable[[int], str]) -> dict:
        p = {"kernel": stacked(layers(lambda i: f"{prefix_fn(i)}.weight"), True)}
        if has(f"{prefix_fn(0)}.bias"):
            p["bias"] = stacked(layers(lambda i: f"{prefix_fn(i)}.bias"), False)
        return p

    def norm_of(name: str) -> dict:
        p = {"weight": stacked(layers(lambda i: f"transformer.h.{i}.{name}.weight"), False)}
        if has(f"transformer.h.0.{name}.bias"):
            p["bias"] = stacked(layers(lambda i: f"transformer.h.{i}.{name}.bias"), False)
        return p

    def block_linears(*names: str) -> dict:
        return {n: linear_of(lambda i, n=n: f"transformer.h.{i}.mlp.{n}") for n in names}

    blocks = {
        "norm_1": norm_of("norm_1"),
        "attn": {"attn": linear_of(lambda i: f"transformer.h.{i}.attn.attn"),
                 "proj": linear_of(lambda i: f"transformer.h.{i}.attn.proj")},
    }
    if has("transformer.h.0.norm_2.weight"):
        blocks["norm_2"] = norm_of("norm_2")

    if cfg.mlp_class_name == "GptNeoxMLP":
        blocks["mlp"] = block_linears("fc", "proj")
    elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
        blocks["mlp"] = block_linears("fc_1", "fc_2", "proj")
    else:  # MoE
        def expert_lin(name: str) -> dict:
            names = [f"transformer.h.{i}.mlp.experts.{e}.{name}.weight"
                     for i in range(cfg.n_layer) for e in range(cfg.n_expert)]
            return {"kernel": stacked(names, True, (cfg.n_layer, cfg.n_expert))}

        blocks["mlp"] = {"gate": linear_of(lambda i: f"transformer.h.{i}.mlp.gate"),
                         "experts": {n: expert_lin(n) for n in ("fc_1", "fc_2", "proj")}}

    params = {
        "wte": get("transformer.wte.weight", False),
        "lm_head": {"kernel": get("lm_head.weight", True)},
        "ln_f": {"weight": get("transformer.ln_f.weight", False)},
        "blocks": blocks,
    }
    if has("lm_head.bias"):
        params["lm_head"]["bias"] = get("lm_head.bias", False)
    if has("transformer.ln_f.bias"):
        params["ln_f"]["bias"] = get("transformer.ln_f.bias", False)
    return params
