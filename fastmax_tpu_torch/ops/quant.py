"""Weight formats of ``fastmax_tpu/ops/quant.py`` on the ported paths: the
rank-1 tiled int4 (``q4r1``) serving format (with ``pack_int4_tiled`` of
``fastmax_tpu/ops/quant_pallas.py``) and the bitsandbytes NF4 format of
QLoRA (``q4``), with its quantizer and optional double quantization.

A q4r1 linear is ``{"q4r1": (gk, gn, tk, 128) int32, "u4": (k,) f32,
"v4": (n,) f32}`` and represents w[k, n] = q[k, n] / 8 * u[k] * v[n] with
signed codes q in [-8, 7]. Within each 1024-column tile the word at
(row r, lane l) holds, in nibble p, the code of column tile*1024 + p*128 + l;
k is zero-padded to a multiple of 512 and n to a multiple of 1024. Stacked
leaves carry a leading (n_layer,) axis.

An NF4 linear is ``{"q4": (k/2, n) uint8, "code": (16,) f32}`` plus either
``"absmax": (k/64, n) f32`` or, double-quantized, ``"absmax_q": (nb, 256)
int8, "absmax_scale": (nb,) f32, "absmax_offset": () f32``. Blocks of 64 run
along the input axis; two codes pack a byte along it, the even row in the
high nibble. The quantizer runs in torch on the tensor's device and gives
the reference's codes bit for bit (the same f32 division and midpoint rule);
the double quantization of the scales, 1/64 of the weights, runs in numpy as
the reference's does, so its mean is summed in the same order. Modes other
than ``bnb.nf4`` and ``bnb.nf4-dq`` (fp4, int8, gptq.int4, GPTQ
calibration) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

INT4_TILE_N = 1024  # 8 nibble planes x 128 lanes
INT4_PAD_K = 512

# The QLoRA NF4 codebook (bitsandbytes' create_normal_map), a copy of the reference's.
NF4_CODE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
     0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0],
    dtype=np.float32)
DEFAULT_BLOCK = 64
DQ_BLOCK = 256  # scale-quantization block of the double quantization
QUANT_MODES = ("bnb.nf4", "bnb.nf4-dq", "bnb.fp4", "bnb.fp4-dq", "bnb.int8", "gptq.int4")


def pack_int4_tiled(codes: np.ndarray, tile_k: int | None = None) -> np.ndarray:
    """Pack signed int4 codes (k, n), values in [-8, 7], into the tiled
    layout (gk, gn, tk, 128) int32 (a copy of the JAX package's packer)."""
    k, n = codes.shape
    k_pad = k + (-k) % INT4_PAD_K
    n_pad = n + (-n) % INT4_TILE_N
    full = np.zeros((k_pad, n_pad), np.int32)
    full[:k, :n] = codes.astype(np.int32)
    tk = tile_k or k_pad
    assert k_pad % tk == 0
    gk, gn = k_pad // tk, n_pad // INT4_TILE_N
    q = (full & 0xF).astype(np.uint32).reshape(k_pad, gn, 8, 128)
    words = np.zeros((k_pad, gn, 128), np.uint32)
    for p in range(8):
        words |= q[:, :, p, :] << (4 * p)
    pw = words.view(np.int32).reshape(gk, tk, gn, 128).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(pw)


def _unpack_int4_tiled(pw_t: torch.Tensor) -> torch.Tensor:
    """Tiled signed-nibble words (gk, gn, tk, 128) -> (k_pad, n_pad) f32.

    Nibble p is taken as ((w >> 4p) & 0xF) and sign-extended, which equals
    the JAX ``(w << (28 - 4p)) >> 28`` without shifting a negative value
    left."""
    gk, gn, tk, _ = pw_t.shape
    planes = []
    for p in range(8):
        nib = (pw_t >> (4 * p)) & 0xF
        planes.append(nib - ((nib >> 3) << 4))
    q = torch.stack(planes, dim=3)  # (gk, gn, tk, 8, 128)
    q = q.permute(0, 2, 1, 3, 4).reshape(gk * tk, gn * INT4_TILE_N)
    return q.float()


def dequantize(p: dict, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense (k, n) kernel of a q4r1 or NF4 linear."""
    if "q4" in p:
        return _dequantize_4bit(p, dtype)
    if "q4r1" not in p:
        raise NotImplementedError(
            f"dequantize: the q4r1 and q4 (NF4) formats are ported (keys {sorted(p)})")
    u, v = p["u4"], p["v4"]
    q = _unpack_int4_tiled(p["q4r1"])[: u.shape[0], : v.shape[0]]
    return (q * 0.125 * u.float()[:, None] * v.float()[None, :]).to(dtype)


# ------------------------------------------------------------------ NF4


def _nearest_code(x: torch.Tensor, code: np.ndarray) -> torch.Tensor:
    """Index of the nearest codebook entry (the midpoint rule on the sorted
    values, ties to the lower one, as ``np.searchsorted(side="left")``)."""
    order = np.argsort(code)
    sorted_code = code[order]
    mids = torch.from_numpy((sorted_code[1:] + sorted_code[:-1]) / 2).to(x.device)
    idx = torch.searchsorted(mids, x.contiguous(), right=False)
    return torch.from_numpy(order.astype(np.int64)).to(x.device)[idx].to(torch.uint8)


def quantize_4bit(kernel: torch.Tensor, kind: str = "nf4", block_size: int = DEFAULT_BLOCK,
                  double_quant: bool = False) -> dict:
    """Quantize an (in, out) kernel to the packed 4-bit dict, on its device."""
    if kind != "nf4":
        raise NotImplementedError(f"the {kind} codebook is not ported yet (ROADMAP queue A, "
                                  "item 3): the port has nf4")
    k_in, k_out = kernel.shape
    if k_in % block_size:
        raise ValueError(f"in-dim {k_in} not divisible by block_size {block_size}")
    w = kernel.float().reshape(k_in // block_size, block_size, k_out)
    absmax = torch.amax(torch.abs(w), dim=1)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    codes = _nearest_code(w / safe[:, None, :], NF4_CODE).reshape(k_in, k_out)
    out = {"q4": (codes[0::2] << 4) | codes[1::2],
           "code": torch.from_numpy(NF4_CODE.copy()).to(kernel.device)}
    if double_quant:
        out.update(_quantize_scales(safe))
    else:
        out["absmax"] = safe
    return out


def _quantize_scales(absmax: torch.Tensor) -> dict:
    """Double quantization: int8 codes of the (nblocks, out) absmax in flat
    blocks of DQ_BLOCK after removing its mean (numpy, as the reference)."""
    flat = absmax.reshape(-1).cpu().numpy()
    offset = np.float32(flat.mean())
    centered = flat - offset
    padded = np.pad(centered, (0, (-centered.size) % DQ_BLOCK))
    blocks = padded.reshape(-1, DQ_BLOCK)
    scale = np.abs(blocks).max(axis=1)
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(blocks / scale[:, None] * 127.0), -128, 127).astype(np.int8)
    return {"absmax_q": torch.from_numpy(q).to(absmax.device),
            "absmax_scale": torch.from_numpy(scale / 127.0).to(absmax.device),
            "absmax_offset": torch.tensor(offset, device=absmax.device)}


def _absmax_of(p: dict, k_in: int, k_out: int) -> torch.Tensor:
    """The (in/64, out) absmax tensor, dequantized from its int8 codes if need be."""
    if "absmax" in p:
        return p["absmax"]
    flat = (p["absmax_q"].float() * p["absmax_scale"][:, None]).reshape(-1)
    n = (k_in // DEFAULT_BLOCK) * k_out
    return (flat[:n] + p["absmax_offset"]).reshape(-1, k_out)


def _dequantize_4bit(p: dict, dtype) -> torch.Tensor:
    """code[nibble] * absmax of its block, in f32, then ``dtype``. The two codes
    of a byte come from one lookup in a (256, 2) table of code pairs (int32
    indices: a quarter of the bytes of int64 ones)."""
    packed = p["q4"]
    k_in, k_out = packed.shape[0] * 2, packed.shape[1]
    code = p["code"].float()
    byte = torch.arange(256, device=packed.device)
    pairs = torch.stack([code[byte >> 4], code[byte & 0xF]], dim=1)
    vals = torch.nn.functional.embedding(packed.int(), pairs)      # (in/2, out, 2)
    vals = vals.permute(0, 2, 1).reshape(k_in // DEFAULT_BLOCK, DEFAULT_BLOCK, k_out)
    absmax = _absmax_of(p, k_in, k_out)
    return (vals * absmax[:, None, :]).reshape(k_in, k_out).to(dtype)


def quantize_linear_params(p: dict, mode: str) -> dict:
    """Swap a dense linear dict for its quantized form (``bnb.nf4``,
    ``bnb.nf4-dq``); a dict without a kernel is returned as it is."""
    if "kernel" not in p:
        return p
    if mode in ("bnb.nf4", "bnb.nf4-dq"):
        q = quantize_4bit(p["kernel"], double_quant=mode.endswith("-dq"))
    elif mode in QUANT_MODES:
        raise NotImplementedError(f"quantize mode {mode!r} is not ported yet (ROADMAP queue A, "
                                  "item 3): the port has bnb.nf4 and bnb.nf4-dq")
    else:
        raise ValueError(f"unknown quantization mode {mode!r}; expected one of {QUANT_MODES}")
    if "bias" in p:
        q["bias"] = p["bias"]
    return q


def quantize_model(params: dict, mode: str, skip=("lm_head", "wte")) -> dict:
    """Quantize every linear kernel of the tree except the top-level modules
    in ``skip`` (embeddings and lm_head stay dense, as bitsandbytes does)."""
    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and path[0] not in skip:
                return _quantize_maybe_stacked(node, mode)
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return {k: walk(v, (k,)) for k, v in params.items()}


def _quantize_maybe_stacked(p: dict, mode: str) -> dict:
    """Quantize a linear whose kernel may carry a leading (n_layer,) axis, one
    layer at a time; every leaf, the codebook too, is stacked on that axis."""
    kernel = p["kernel"]
    if kernel.dim() == 2:
        return quantize_linear_params(p, mode)
    slices = [quantize_linear_params({"kernel": kernel[i]}, mode) for i in range(kernel.shape[0])]
    out = {key: torch.stack([s[key] for s in slices]) for key in slices[0]}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out
