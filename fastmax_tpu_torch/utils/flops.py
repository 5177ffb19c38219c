"""FLOP estimates for throughput and MFU (counterpart of
``fastmax_tpu/utils/flops.py``, whose estimate it copies), with the peak
rates of the card the port runs on."""

from __future__ import annotations

from typing import Optional

from ..models.config import Config


def flops_per_param(max_seq_length: int, n_layer: int, n_embd: int, n_params: int) -> int:
    flops_per_token = 2 * n_params  # each parameter is used in a MAC
    flops_per_seq = flops_per_token * max_seq_length
    attn_flops_per_seq = n_layer * 2 * 2 * (n_embd * (max_seq_length**2))
    return flops_per_seq + attn_flops_per_seq


def estimate_flops(cfg: Config, n_params: int, max_seq_length: int, training: bool = True) -> int:
    """Forward(+backward) FLOPs per sequence. The backward multiplier 2.0
    follows the reference's convention (recompute not counted)."""
    flops = flops_per_param(max_seq_length, cfg.n_layer, cfg.n_embd, n_params)
    mult = 3 if training else 1  # fwd + 2x bwd
    return flops * mult


# dense peak FLOP/s of one NVIDIA H100 SXM by training dtype (NVIDIA data sheet):
# bf16 on the tensor cores, float32 outside them
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def device_peak_flops(device_kind: str, dtype: str = "float32") -> Optional[float]:
    """The card's peak for ``dtype``, or None for a device this table does not
    name (the CPU, another GPU)."""
    if "H100" not in device_kind:
        return None
    return H100_PEAK_FLOPS.get(dtype)


def mfu(tokens_per_sec: float, cfg: Config, n_params: int, seq_len: int, device_kind: str,
        dtype: str = "float32") -> Optional[float]:
    peak = device_peak_flops(device_kind, dtype)
    if peak is None:
        return None
    flops_per_tok = estimate_flops(cfg, n_params, seq_len, training=True) / seq_len
    return tokens_per_sec * flops_per_tok / peak
