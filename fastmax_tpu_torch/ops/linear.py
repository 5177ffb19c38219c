"""Linear and embedding application (counterpart of
``fastmax_tpu/ops/linear.py``), for the weight formats of the ported path.

A linear's parameters are dense ``{"kernel": (in, out)}``, rank-1 int4
``{"q4r1", "u4", "v4"}`` or NF4 ``{"q4", "code", "absmax" | "absmax_q",
"absmax_scale", "absmax_offset"}`` (ops/quant.py), with an optional
``"bias"`` (out,) added in the output's dtype and optional LoRA leaves
``{"lora_A": (in, r), "lora_B": (r, out), "lora_scale": (), ["lora_mask":
(out,)]}`` (models/lora.py), which add ``((x @ A) @ B) * scale * mask`` to
the base output before the bias. NF4 takes the reference's ``"xla"``
backend: dequantize, then ``torch.matmul`` (its Pallas kernel B7 serves
inference only and has no gradient). With ``layer`` given, every leaf
carries a leading (n_layer,) axis and the call computes that layer: dense
leaves are indexed (a view), q4r1 leaves go to the stacked int4 kernel,
which reads the stack in place. Adapter leaves and the q8/q4b formats are
not ported yet.
"""

from __future__ import annotations

import torch

from .quant import dequantize
from .quant_kernels import int4_matmul_rank1, int4_matmul_rank1_stacked

_NF4 = {"q4", "code", "absmax", "absmax_q", "absmax_scale", "absmax_offset"}
_LORA = {"lora_A", "lora_B", "lora_scale", "lora_mask"}
_PORTED = {"kernel", "q4r1", "u4", "v4", "bias"} | _NF4 | _LORA


def linear(p: dict, x: torch.Tensor, layer=None, *, plain: bool = False) -> torch.Tensor:
    extra = set(p) - _PORTED
    if extra:
        raise NotImplementedError(
            f"linear: leaves {sorted(extra)} are not ported yet (adapter and the q8/q4b "
            "formats come in later slices)")
    if layer is not None and (p.keys() & (_NF4 | _LORA)):
        p = {k: a[layer] for k, a in p.items()}
        layer = None
    if "q4r1" in p:
        if layer is not None:
            y = int4_matmul_rank1_stacked(x, p, layer, plain=plain)
        else:
            y = int4_matmul_rank1(x, p, plain=plain)
    elif "kernel" in p:
        w = p["kernel"] if layer is None else p["kernel"][layer]
        y = torch.matmul(x, w.to(x.dtype))
    elif "q4" in p:
        y = torch.matmul(x, dequantize(p, x.dtype))
    else:
        raise KeyError(f"linear params missing weight: keys={list(p)}")
    if "lora_A" in p:
        delta = torch.matmul(torch.matmul(x, p["lora_A"].to(x.dtype)), p["lora_B"].to(x.dtype))
        delta = delta * p["lora_scale"].to(x.dtype)
        if "lora_mask" in p:
            delta = delta * p["lora_mask"].to(x.dtype)
        y = y + delta
    bias = p.get("bias")
    if bias is not None:
        y = y + (bias if layer is None else bias[layer]).to(y.dtype)
    return y


def embedding(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]
