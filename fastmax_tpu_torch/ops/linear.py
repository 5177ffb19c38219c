"""Linear and embedding application (counterpart of
``fastmax_tpu/ops/linear.py``).

A linear's parameters are dense ``{"kernel": (in, out)}`` or one of the
quantized formats of ops/quant.py (4-bit ``q4``, int8 ``q8``, rank-1 int4
``q4r1``, blockwise int4 ``q4b``), with an optional ``"bias"`` (out,) added
in the output's dtype and optional LoRA leaves ``{"lora_A": (in, r),
"lora_B": (r, out), "lora_scale": (), ["lora_mask": (out,)]}``
(models/lora.py), which add ``((x @ A) @ B) * scale * mask`` to the base
output before the bias, and optional LLaMA-Adapter v2 leaves
``{"adapter_scale": (out,), "adapter_bias": (out,)}`` (models/adapter.py),
applied after the bias: ``y * adapter_scale + adapter_bias``. Quantized
linears go through ``quant.quantized_matmul``, as the reference's do. With
``layer`` given, every leaf carries a leading (n_layer,) axis and the call
computes that layer: a q4r1 linear without LoRA goes to the stacked int4
kernel, which reads the stack in place; every other linear takes per-layer
views of its leaves (which cost nothing).
"""

from __future__ import annotations

import torch

from . import quant
from .quant_kernels import int4_matmul_rank1_stacked

_QUANT = {"q4", "code", "absmax", "absmax_q", "absmax_scale", "absmax_offset", "q8", "scale8",
          "q4r1", "u4", "v4", "q4b", "scale4", "n4", "k4"}
_LORA = {"lora_A", "lora_B", "lora_scale", "lora_mask"}
_ADAPTER = {"adapter_scale", "adapter_bias"}
_KNOWN = {"kernel", "bias"} | _QUANT | _LORA | _ADAPTER


def linear(p: dict, x: torch.Tensor, layer=None, *, plain: bool = False) -> torch.Tensor:
    extra = set(p) - _KNOWN
    if extra:
        raise KeyError(f"linear: unknown leaves {sorted(extra)}")
    if layer is not None and not ("q4r1" in p and not p.keys() & _LORA):
        p = {k: a[layer] for k, a in p.items()}
        layer = None
    if "kernel" in p:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    elif "q4r1" in p and layer is not None:
        y = int4_matmul_rank1_stacked(x, p, layer, plain=plain)
    elif p.keys() & {"q4", "q8", "q4r1", "q4b"}:
        y = quant.quantized_matmul(x, p, plain=plain)
    else:
        raise KeyError(f"linear params missing weight: keys={list(p)}")
    if "lora_A" in p:
        delta = torch.matmul(torch.matmul(x, p["lora_A"].to(x.dtype)), p["lora_B"].to(x.dtype))
        delta = delta * p["lora_scale"].to(x.dtype)
        if "lora_mask" in p:
            delta = delta * p["lora_mask"].to(x.dtype)
        y = y + delta

    def leaf(name):
        return p[name] if layer is None else p[name][layer]

    if "bias" in p:
        y = y + leaf("bias").to(y.dtype)
    if "adapter_scale" in p:
        y = y * leaf("adapter_scale").to(y.dtype) + leaf("adapter_bias").to(y.dtype)
    return y


def embedding(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]
