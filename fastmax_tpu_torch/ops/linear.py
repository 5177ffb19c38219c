"""Linear and embedding application (counterpart of
``fastmax_tpu/ops/linear.py``), for the weight formats of the ported path.

A linear's parameters are either dense ``{"kernel": (in, out)}`` or rank-1
int4 ``{"q4r1", "u4", "v4"}`` (ops/quant.py), with an optional ``"bias"``
(out,) added in the output's dtype. With ``layer`` given, every leaf carries
a leading (n_layer,) axis and the call computes that layer: dense leaves are
indexed (a view), q4r1 leaves go to the stacked int4 kernel, which reads the
stack in place. LoRA, adapter and the q8/q4/q4b formats are not on the
ported paths and are not ported yet.
"""

from __future__ import annotations

import torch

from .quant_kernels import int4_matmul_rank1, int4_matmul_rank1_stacked

_PORTED = {"kernel", "q4r1", "u4", "v4", "bias"}


def linear(p: dict, x: torch.Tensor, layer=None, *, plain: bool = False) -> torch.Tensor:
    extra = set(p) - _PORTED
    if extra:
        raise NotImplementedError(
            f"linear: leaves {sorted(extra)} are not ported yet (LoRA, adapter and "
            "q8/q4/q4b formats come in later slices)")
    if "q4r1" in p:
        if layer is not None:
            y = int4_matmul_rank1_stacked(x, p, layer, plain=plain)
        else:
            y = int4_matmul_rank1(x, p, plain=plain)
    elif "kernel" in p:
        w = p["kernel"] if layer is None else p["kernel"][layer]
        y = torch.matmul(x, w.to(x.dtype))
    else:
        raise KeyError(f"linear params missing weight: keys={list(p)}")
    bias = p.get("bias")
    if bias is not None:
        y = y + (bias if layer is None else bias[layer]).to(y.dtype)
    return y


def embedding(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]
