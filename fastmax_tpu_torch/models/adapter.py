"""LLaMA-Adapter v1 and v2 as extra leaves of the parameter tree
(counterpart of ``fastmax_tpu/models/adapter.py``).

v1: a learnable prompt of ``adapter_prompt_length`` embeddings a layer, whose
keys and values (through the block's own QKV projection, without RoPE) take
unmasked attention from every query, gated by a zero-initialised per-head
``gating`` and added to the attention output (``models/gpt._finish_attn``,
quadratic arm only, as in the reference). The layers below
``adapter_start_layer`` have ``on`` = 0, so they add nothing and get no
gradient.

v2: every linear but the MoE experts (which ``gpt.apply_moe`` contracts
directly) also carries an elementwise ``adapter_scale`` (ones) and
``adapter_bias`` (zeros), ``y = scale * linear(x) + bias``
(``ops/linear.linear``); its trainable set adds every norm and bias.

The leaves stack on the (n_layer,) axis like the base weights:

  blocks.attn.adapter = {"wte": (L, aT, E), "gating": (L, n_head), "on": (L,)}
  every linear [v2]   += {"adapter_scale": (out,), "adapter_bias": (out,)}

The prompt is drawn from an explicit ``torch.Generator`` (the numbers
differ from the JAX package's; tests bring its leaves over instead).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .config import Config


@dataclass
class AdapterConfig:
    adapter_prompt_length: int = 10
    adapter_start_layer: int = 2


def add_adapter_params(params: dict, cfg: Config, ad: AdapterConfig, gen: torch.Generator,
                       dtype=torch.float32, v2: bool = False) -> dict:
    """params with the adapter leaves added (a new tree; the base tensors are
    shared, not copied). ``gen`` must live on the parameters' device."""
    device = params["wte"].device

    def copy(node):
        return {k: copy(v) for k, v in node.items()} if isinstance(node, dict) else node

    out = copy(params)
    n = cfg.n_layer
    wte = torch.randn((n, ad.adapter_prompt_length, cfg.n_embd), generator=gen,
                      device=device) * 0.02
    on = (torch.arange(n, device=device) >= ad.adapter_start_layer).to(dtype)
    out["blocks"]["attn"]["adapter"] = {
        "wte": wte.to(dtype),
        "gating": torch.zeros((n, cfg.n_head), dtype=dtype, device=device),
        "on": on,
    }
    return _add_v2_wrappers(out, dtype) if v2 else out


def _add_v2_wrappers(params: dict, dtype) -> dict:
    """adapter_scale/adapter_bias on every linear (the lm_head too) but the
    MoE experts."""
    def walk(node, path=()):
        if not isinstance(node, dict):
            return node
        node = {k: walk(v, path + (k,)) for k, v in node.items()}
        weight = node.get("kernel", node.get("q4", node.get("q8")))
        if weight is not None and "experts" not in path:
            shape = tuple(weight.shape[:-2]) + (weight.shape[-1],)
            node["adapter_scale"] = torch.ones(shape, dtype=dtype, device=weight.device)
            node["adapter_bias"] = torch.zeros(shape, dtype=dtype, device=weight.device)
        return node

    return walk(params)


def apply_adapter_attention(adapter: dict, attn_linear: dict, q: torch.Tensor, cfg: Config,
                            scale: float, layer=None, *, plain: bool = False) -> torch.Tensor:
    """The prefix attention's delta (B, n_head, T, hs) for one layer.

    ``adapter`` holds this layer's leaves; ``attn_linear`` is the fused QKV
    linear (stacked, with ``layer``); q (B, n_head, T, hs) is post-RoPE. The
    prompt's k and v come through the same projection, without RoPE, and
    take no mask. A tree read back from a delta file has no ``on`` (the
    reference's checkpoint filter leaves it out): the gate is then
    ``gating`` alone, which is zero in the layers that ``on`` turned off, as
    neither their gradient nor their weight decay ever moves it."""
    from ..ops.attention import scaled_dot_product_attention
    from ..ops.linear import linear

    wte = adapter["wte"]  # (aT, E)
    a_t = wte.shape[0]
    b = q.shape[0]
    g, hs = cfg.n_query_groups, cfg.head_size
    q_per_kv = cfg.n_head // g
    aqkv = linear(attn_linear, wte[None], layer, plain=plain).reshape(1, a_t, g, q_per_kv + 2, hs)
    ak = aqkv[..., q_per_kv, :].permute(0, 2, 1, 3).expand(b, g, a_t, hs)
    av = aqkv[..., q_per_kv + 1, :].permute(0, 2, 1, 3).expand(b, g, a_t, hs)
    ay = scaled_dot_product_attention(q, ak, av, mask=None, scale=scale)
    gate = adapter["gating"] * adapter["on"] if "on" in adapter else adapter["gating"]
    return ay * gate[None, :, None, None]


# ------------------------------------------------------------------- masks


def trainable_mask(params: dict, v2: bool = False) -> dict:
    """v1: the adapter's wte and gating. v2: also adapter_scale/adapter_bias,
    every norm parameter and every linear's bias."""
    def fn(names) -> bool:
        leaf = names[-1]
        if "adapter" in names and leaf in ("wte", "gating"):
            return True
        if v2:
            if leaf in ("adapter_scale", "adapter_bias", "bias"):
                return True
            if any(n.startswith("norm") or n == "ln_f" for n in names):
                return True
        return False

    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else fn(path + (k,))
                for k, v in node.items()}

    return walk(params, ())


def adapter_filter_flat(name: str, v2: bool = False) -> bool:
    """Checkpoint filter for adapter-only saves, on flat tree names."""
    if any(s in name for s in ("adapter_wte", "gating_factor", "adapter.wte", "adapter.gating")):
        return True
    if v2:
        return any(s in name for s in ("adapter_scale", "adapter_bias", "norm_1", "norm_2",
                                       "ln_f", ".bias"))
    return False
