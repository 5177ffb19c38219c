"""Weight-only quantization (counterpart of ``fastmax_tpu/ops/quant.py``,
with ``pack_int4_tiled`` and ``tile_scales`` of ``quant_pallas.py``).

A linear's parameter dict is one of:

  {"kernel": (in, out)}                                           dense
  {"q4": (in/2, out) u8, "code": (16,) f32, "absmax": (in/64, out) f32}
                                                                  4-bit codebook
  {"q4", "code", "absmax_q": (nb, 256) i8, "absmax_scale": (nb,) f32,
   "absmax_offset": () f32}                                       4-bit, double quant
  {"q8": (in, out) i8, "scale8": (out,) f32}                      per-channel int8
  {"q4r1": (gk, gn, tk, 128) i32, "u4": (in,) f32, "v4": (out,) f32}
                                                                  rank-1 tiled int4
  {"q4b": (gk, gn, tk, 128) i32, "scale4": (gk, gn, tk/64, 1024) f32,
   "n4": (out, 0) u8, "k4": (in, 0) u8}                           blockwise tiled int4

plus an optional "bias". Stacked leaves carry a leading (n_layer,) axis.

4-bit codebooks (NF4, FP4, uniform int4 for gptq.int4) quantize blocks of 64
along the input axis by their absmax; two codes pack a byte along that axis,
the even row in the high nibble. The tiled formats hold signed codes q in
[-8, 7], 8 to an int32 word: within each 1024-column tile the word at (row
r, lane l) holds in nibble p the code of column tile*1024 + p*128 + l; k is
zero-padded to a multiple of 512 and n to one of 1024. Rank-1: w = q/8 *
u[k] * v[n]; blockwise: w = q * (absmax[k/64, n] / 8). The zero-size
``n4``/``k4`` markers carry the true widths in their shapes.

The quantizers run in torch on the tensor's device and give the reference's
codes bit for bit: the same float32 divisions, half-to-even rounding (as
``np.round``), the midpoint rule of ``np.searchsorted``, the rank-1 envelope
in float64, and the tiled words packed in torch. The double quantization of
the scales (1/64 of the weights) runs in numpy as the reference's does, so
its mean is summed in the same order. The model-level conversions work one
layer at a time, so that at most one layer's float32 kernel is alive.

``quantized_matmul`` routes a linear as the reference does. Its 4-bit
backend keeps the reference's two names: "xla" dequantizes and multiplies
with ``torch.matmul``; "pallas" sends eligible linears to the hand-written
exact-codebook kernel (``ops/quant_kernels.nf4_matmul``, K8).
GPTQ calibration lives in ``ops/gptq.py``: it gives codes of these formats
from activations, where ``quantize_model`` rounds to nearest.
"""

from __future__ import annotations

import time

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
# bitsandbytes FP4: a 3-bit magnitude table and the sign in the high bit
_FP4_MAG = np.array([0.0, 0.0052083334, 0.6666667, 1.0, 0.33333334, 0.5, 0.16666667, 0.25],
                    dtype=np.float32)
FP4_CODE = np.concatenate([_FP4_MAG, -_FP4_MAG]).astype(np.float32)
INT4_CODE = (np.arange(-8, 8, dtype=np.float32) / 8.0).astype(np.float32)  # gptq.int4
CODEBOOKS = {"nf4": NF4_CODE, "fp4": FP4_CODE, "int4": INT4_CODE}
DEFAULT_BLOCK = 64
DQ_BLOCK = 256  # scale-quantization block of the double quantization
QUANT_MODES = ("bnb.nf4", "bnb.nf4-dq", "bnb.fp4", "bnb.fp4-dq", "bnb.int8", "gptq.int4")

# the rank of each leaf in one layer: a leaf with more dimensions is stacked
_RANK = {"kernel": 2, "q4": 2, "q8": 2, "absmax": 2, "code": 1, "absmax_q": 2,
         "absmax_scale": 1, "absmax_offset": 0, "scale8": 1,
         "q4r1": 4, "u4": 1, "v4": 1, "q4b": 4, "scale4": 4, "n4": 2, "k4": 2}


# ------------------------------------------------------------- tiled int4


def pack_int4_tiled(codes, tile_k: int | None = None):
    """Pack signed int4 codes (k, n), values in [-8, 7], into the tiled
    layout (gk, gn, tk, 128) int32, on the codes' device. A numpy array in
    gives a numpy array out, equal to the JAX package's packer."""
    if isinstance(codes, np.ndarray):
        return pack_int4_tiled(torch.from_numpy(codes.astype(np.int32)), tile_k).numpy()
    k, n = codes.shape
    k_pad = k + (-k) % INT4_PAD_K
    n_pad = n + (-n) % INT4_TILE_N
    tk = tile_k or k_pad
    assert k_pad % tk == 0
    gk, gn = k_pad // tk, n_pad // INT4_TILE_N
    nib = torch.zeros((k_pad, n_pad), dtype=torch.int32, device=codes.device)
    nib[:k, :n] = codes.to(torch.int32) & 0xF
    nib = nib.reshape(k_pad, gn, 8, 128)
    words = nib[:, :, 0].long()
    for p in range(1, 8):
        words |= nib[:, :, p].long() << (4 * p)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)  # two's complement
    return words.reshape(gk, tk, gn, 128).permute(0, 2, 1, 3).contiguous()


def tile_scales(absmax: torch.Tensor, tk: int, n_pad: int) -> torch.Tensor:
    """(k/64, n) f32 -> (gk, gn, tk/64, 1024), zero-padded, in the column
    layout of ``pack_int4_tiled`` (the identity within a tile)."""
    nb, n = absmax.shape
    k_pad_blocks = nb + (-nb) % (INT4_PAD_K // DEFAULT_BLOCK)
    full = torch.zeros((k_pad_blocks, n_pad), dtype=torch.float32, device=absmax.device)
    full[:nb, :n] = absmax
    nbt = tk // DEFAULT_BLOCK
    gk, gn = k_pad_blocks // nbt, n_pad // INT4_TILE_N
    return full.reshape(gk, nbt, gn, INT4_TILE_N).permute(0, 2, 1, 3).contiguous()


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


def rank1_envelope(absmax: torch.Tensor, iters: int = 8):
    """Minimal-ish rank-1 envelope u (x) v >= absmax (k-block x column), by
    alternating max-ratio descent from u = row max, in float64 as the
    reference computes it; returns float32 (u, v)."""
    u = torch.clamp(absmax.amax(dim=1), min=1e-12).double()  # the clamp in f32, as numpy's
    a = absmax.double()
    v = None
    for _ in range(iters):
        v = torch.clamp((a / u[:, None]).amax(dim=0), min=1e-12)
        u = torch.clamp((a / v[None, :]).amax(dim=1), min=1e-12)
    return u.float(), v.float()


def quantize_int4_tiled(kernel: torch.Tensor, scheme: str = "rank1",
                        block_size: int = DEFAULT_BLOCK) -> dict:
    """Quantize an (in, out) kernel to a tiled int4 serving dict, on its
    device: "rank1" -> {"q4r1", "u4", "v4"}, "block" -> {"q4b", "scale4",
    "n4", "k4"}."""
    w = kernel.float()
    k_in, k_out = w.shape
    w = torch.nn.functional.pad(w, (0, 0, 0, (-k_in) % block_size))
    wb = w.reshape(-1, block_size, k_out)
    absmax = torch.amax(torch.abs(wb), dim=1)
    absmax = torch.where(absmax == 0, torch.full_like(absmax, 1e-12), absmax)
    n_pad = k_out + (-k_out) % INT4_TILE_N
    if scheme == "rank1":
        ub, v = rank1_envelope(absmax)
        step = (ub[:, None, None] * v[None, None, :]) / 8.0
        q = torch.clamp(torch.round(wb / step), -8, 7).to(torch.int8)
        return {"q4r1": pack_int4_tiled(q.reshape(-1, k_out)),
                "u4": torch.repeat_interleave(ub, block_size)[:k_in], "v4": v}
    q = torch.clamp(torch.round(wb * 8.0 / absmax[:, None, :]), -8, 7).to(torch.int8)
    pw = pack_int4_tiled(q.reshape(-1, k_out))
    empty = dict(dtype=torch.uint8, device=kernel.device)
    return {"q4b": pw, "scale4": tile_scales(absmax, pw.shape[2], n_pad),
            "n4": torch.zeros((k_out, 0), **empty), "k4": torch.zeros((k_in, 0), **empty)}


# ------------------------------------------------------------- int8


def quantize_int8(kernel: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 (the bnb.int8 inference role)."""
    w = kernel.float()
    scale = torch.amax(torch.abs(w), dim=0) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale[None, :]), -128, 127).to(torch.int8)
    return {"q8": q, "scale8": scale}


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale8: torch.Tensor) -> torch.Tensor:
    """x @ (q8 * scale8) with the per-channel scale applied to the output, as
    the reference: the unscaled sum in f32 (a bf16 x times an int8 code is
    exact in f32), scaled, then cast to x's dtype once."""
    acc = torch.matmul(x.float(), q8.float())
    return (acc * scale8).to(x.dtype)


# ------------------------------------------------------------- 4-bit codebooks


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
    code = CODEBOOKS[kind]
    k_in, k_out = kernel.shape
    if k_in % block_size:
        raise ValueError(f"in-dim {k_in} not divisible by block_size {block_size}")
    w = kernel.float().reshape(k_in // block_size, block_size, k_out)
    absmax = torch.amax(torch.abs(w), dim=1)
    safe = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    codes = _nearest_code(w / safe[:, None, :], code).reshape(k_in, k_out)
    out = {"q4": (codes[0::2] << 4) | codes[1::2],
           "code": torch.from_numpy(code.copy()).to(kernel.device)}
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


def dequantize(p: dict, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense (in, out) kernel of one quantized linear."""
    if "q8" in p:
        return (p["q8"].float() * p["scale8"][None, :]).to(dtype)
    if "q4r1" in p:
        u, v = p["u4"], p["v4"]
        q = _unpack_int4_tiled(p["q4r1"])[: u.shape[0], : v.shape[0]]
        return (q * 0.125 * u.float()[:, None] * v.float()[None, :]).to(dtype)
    if "q4b" in p:
        s_t = p["scale4"]  # (gk, gn, nb, 1024)
        gk, gn, nb, _ = s_t.shape
        q = _unpack_int4_tiled(p["q4b"])
        k_true = p["k4"].shape[0] if "k4" in p else q.shape[0]
        s = s_t.permute(0, 2, 1, 3).reshape(gk * nb, gn * INT4_TILE_N)
        w = q.reshape(-1, DEFAULT_BLOCK, q.shape[1]) * 0.125 * s[:, None, :]
        return w.reshape(q.shape)[:k_true, : p["n4"].shape[0]].to(dtype)
    return _dequantize_4bit(p, dtype)


# ------------------------------------------------------------- routing

# Which implementation runs 4-bit (``q4``) matmuls: "xla" dequantizes and
# multiplies with torch.matmul; "pallas" sends eligible linears to K8. The
# engine's autotune picks one on the card; it is process-global, as the
# reference's.
_QUANT_BACKEND = "xla"
# the times of the last autotune (seconds for ``iters`` calls of each)
LAST_AUTOTUNE: dict = {}


def set_quant_backend(name: str) -> None:
    global _QUANT_BACKEND
    if name not in ("xla", "pallas"):
        raise ValueError(name)
    _QUANT_BACKEND = name


def get_quant_backend() -> str:
    return _QUANT_BACKEND


def autotune_quant_backend(sample_p: dict, sample_x: torch.Tensor, iters: int = 20) -> str:
    """Time both 4-bit matmul routes on a representative linear and select
    the faster. Off the card, or for a linear K8 does not take, "xla"."""
    from .quant_kernels import pallas_eligible, quantized_matmul_pallas

    k_in, k_out = sample_p["q4"].shape[0] * 2, sample_p["q4"].shape[1]
    if not sample_x.is_cuda or not pallas_eligible(sample_p, k_in, k_out):
        set_quant_backend("xla")
        return _QUANT_BACKEND
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune_quant_backend reads the clock: not inside a CUDA-graph "
                           "capture")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t_kernel = timed(lambda: quantized_matmul_pallas(sample_x, sample_p))
    t_xla = timed(lambda: torch.matmul(sample_x, dequantize(sample_p, sample_x.dtype)))
    LAST_AUTOTUNE.clear()
    LAST_AUTOTUNE.update(pallas_s=t_kernel, xla_s=t_xla, iters=iters, k=k_in, n=k_out)
    set_quant_backend("pallas" if t_kernel < t_xla else "xla")
    return _QUANT_BACKEND


def quantized_matmul(x: torch.Tensor, p: dict, *, plain: bool = False) -> torch.Tensor:
    """x @ dequant(kernel) for one quantized linear, routed as the
    reference's: q8 -> ``int8_matmul``, q4r1/q4b -> the tiled int4 kernels,
    q4 -> K8 under the "pallas" backend where it takes the shape (and x needs
    no gradient: K8 has none), else dequantize + matmul. ``plain`` sends a
    kernel call to its plain version."""
    if "q8" in p:
        return int8_matmul(x, p["q8"], p["scale8"])
    from . import quant_kernels as qk

    if "q4r1" in p:
        return qk.int4_matmul_rank1(x, p, plain=plain)
    if "q4b" in p:
        return qk.int4_matmul_block(x, p, plain=plain)
    k_in, k_out = p["q4"].shape[0] * 2, p["q4"].shape[1]
    if _QUANT_BACKEND == "pallas" and not x.requires_grad and qk.pallas_eligible(p, k_in, k_out):
        return qk.quantized_matmul_pallas(x, p, plain=plain)
    return torch.matmul(x, dequantize(p, x.dtype))


# ------------------------------------------------------------- model trees


# a linear's leaves that every re-representation of its weight keeps as they are
_KEPT = ("bias", "adapter_scale", "adapter_bias")


def _per_layer(node: dict, lead_key: str, fn) -> dict:
    """``fn`` over one linear dict (its bias and adapter-v2 leaves aside),
    one layer at a time when the ``lead_key`` leaf carries stack axes: each
    result leaf is written into a stack allocated at the first layer, so only
    one layer's intermediates are alive at once. The leaves set aside are
    kept as they are (the reference keeps only the bias and drops a v2
    adapter's scale and bias)."""
    body = {k: v for k, v in node.items() if k not in _KEPT}
    lead = tuple(node[lead_key].shape[:-2])
    if not lead:
        out = fn(body)
    else:
        out = {}
        for idx in np.ndindex(*lead):
            part = fn({k: v[idx] if v.ndim > _RANK.get(k, 0) else v for k, v in body.items()})
            for key, val in part.items():
                if key not in out:
                    out[key] = val.new_empty(lead + tuple(val.shape))
                out[key][idx] = val
    out.update({k: node[k] for k in _KEPT if k in node})
    return out


def _map_linears(params: dict, keys: tuple, fn) -> dict:
    """Apply ``fn`` (see ``_per_layer``) to every linear dict holding one of
    ``keys``; other nodes are walked, leaves kept."""
    def walk(node):
        if isinstance(node, dict):
            lead_key = next((k for k in keys if k in node), None)
            if lead_key is not None:
                return _per_layer(node, lead_key, fn)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def dequantize_model(params: dict, dtype=torch.bfloat16) -> dict:
    """Every 4-bit and int8 linear as a dense ``dtype`` kernel ("preload")."""
    return _map_linears(params, ("q4", "q8"), lambda p: {"kernel": dequantize(p, dtype)})


def requantize_int4_model(params: dict, scheme: str = "rank1") -> dict:
    """Every 4-bit and int8 linear as tiled int4 ("preload_int4" with
    "rank1", "preload_int4_block" with "block"); tiled int4 and dense
    linears stay as they are."""
    return _map_linears(params, ("q4", "q8"),
                        lambda p: quantize_int4_tiled(dequantize(p, torch.float32), scheme))


def requantize_int8_model(params: dict) -> dict:
    """Every 4-bit linear as per-channel int8 ("preload_int8"); int8 and
    dense linears stay as they are."""
    return _map_linears(params, ("q4",), lambda p: quantize_int8(dequantize(p, torch.float32)))


def quantize_linear_params(p: dict, mode: str) -> dict:
    """Swap a dense linear dict for its quantized form; ``mode`` follows the
    reference's CLI spelling. A dict without a kernel is returned as it is."""
    if "kernel" not in p:
        return p
    kernel = p["kernel"]
    if mode == "bnb.int8":
        q = quantize_int8(kernel)
    elif mode in ("bnb.nf4", "bnb.nf4-dq", "bnb.fp4", "bnb.fp4-dq"):
        kind = mode.split(".")[1].split("-")[0]
        q = quantize_4bit(kernel, kind=kind, double_quant=mode.endswith("-dq"))
    elif mode == "gptq.int4":
        q = quantize_4bit(kernel, kind="int4")
    else:
        raise ValueError(f"unknown quantization mode {mode!r}; expected one of {QUANT_MODES}")
    q.update({k: p[k] for k in _KEPT if k in p})
    return q


def quantize_model(params: dict, mode: str, skip=("lm_head", "wte")) -> dict:
    """Quantize every linear kernel of the tree except the top-level modules
    in ``skip`` (embeddings and lm_head stay dense, as bitsandbytes does) and
    MoE experts, one layer at a time; every leaf, the codebook too, is
    stacked on the layer axis."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}; expected one of {QUANT_MODES}")

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and path[0] not in skip and "experts" not in path:
                return _quantize_maybe_stacked(node, mode)
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return {k: walk(v, (k,)) for k, v in params.items()}


def _quantize_maybe_stacked(p: dict, mode: str) -> dict:
    """Quantize a linear whose kernel may carry leading stack axes, one layer
    at a time."""
    return _per_layer(p, "kernel", lambda sub: quantize_linear_params(sub, mode))
