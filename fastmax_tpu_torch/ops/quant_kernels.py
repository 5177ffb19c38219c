"""The fused dequantize + matmul kernels of ``fastmax_tpu/ops/quant_pallas.py``:

* rank-1 tiled int4 (q4r1), ``y = ((x * u) @ Q) * (v / 8)``: K1,
  ``csrc/int4_rank1_matmul.cu`` (one kernel for the stacked and the
  per-layer Pallas kernels: it takes a pointer to one layer of the stack);
* blockwise tiled int4 (q4b), ``y = x @ (Q * (s / 8))``, or the raw nibbles
  without scales: K9, ``csrc/int4_block_matmul.cu`` (``int4_matmul_tiled``);
* the exact 4-bit codebook (q4: NF4, FP4 or int4 levels), per 64-row block
  ``absmax * (x_even @ code[hi] + x_odd @ code[lo])``: K8,
  ``csrc/nf4_matmul.cu`` (``nf4_matmul``).

Each accumulates in float32. A CUDA tensor goes to the kernel; a CPU tensor,
or ``plain=True``, goes to the ``*_plain`` version beside it, which repeats
the kernel's arithmetic in PyTorch. The routing follows the JAX wrappers:
int4 rows beyond a kernel's cap go to a plain dequantize + matmul, as the
reference sends them to XLA; ``nf4_matmul`` has no row cap, and
``pallas_eligible`` keeps the reference's shape condition.
"""

from __future__ import annotations

import functools
import math

import torch

from ..kernels.build import KERNELS, use_kernel
from .quant import DEFAULT_BLOCK, INT4_TILE_N, _absmax_of, _unpack_int4_tiled, dequantize

_INT4_MAX_M = 128   # per-layer entry: larger m goes to dequantize + matmul
GEMV_MAX_M = 4      # K1 and K9 stream weights for m <= 4,
TC_MAX_M = 64       # run the tensor cores up to 64 rows, and tile 64 rows above
_GEMV_K_STEP = 128  # k rows per unrolled gemv step (32 row threads x 4)
_TC_K_STEP = 64     # 16-row mma steps x 4 warps
_GEMM_K_STEP = 32
# B7's tiles: the route sends a q4 linear to the kernel when k and n are
# multiples of them (K8 itself takes k % 64 == 0 and n % 8 == 0)
TILE_K = 512
TILE_N = 256
NF4_GEMV_MAX_M = 4  # K8 streams weights for m <= 4 (its gemv takes m <= 8),
NF4_TC_MAX_M = 64   # runs the tensor cores up to 64 rows, and tiles 64 rows above
_NF4_PATHS = ("gemv", "tc", "fma")  # the C entry's path argument, by index


def int4_matmul_rank1_plain(x: torch.Tensor, q4r1: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """x (m, k) @ one layer's q4r1 (gk, gn, tk, 128) with u (k,), v (n,) ->
    (m, n) f32. x and u are zero-padded to k_pad and v to n_pad, as in the
    Pallas wrapper."""
    gk, gn, tk, _ = q4r1.shape
    k_pad, n_pad = gk * tk, gn * INT4_TILE_N
    k, n = u.shape[0], v.shape[0]
    xs = torch.nn.functional.pad(x.float(), (0, k_pad - k))
    up = torch.nn.functional.pad(u.float(), (0, k_pad - k))
    vp = torch.nn.functional.pad(v.float(), (0, n_pad - n))
    y = torch.matmul(xs * up, _unpack_int4_tiled(q4r1)) * (vp * 0.125)
    return y[:, :n]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int4_path(m: int, tk: int) -> str:
    """The kernel of the tiled int4 matmuls (K1 and K9) for m rows of x over k
    tiles of tk rows: "gemv" (m <= 4), "tc" (the tensor cores, 4 < m <=
    TC_MAX_M, tk % 16 == 0) or "fma" (the 64-row f32 tile)."""
    if m <= GEMV_MAX_M:
        return "gemv"
    if m <= TC_MAX_M and tk % 16 == 0:
        return "tc"
    return "fma"


def _splits(m: int, k: int, gn: int, sm_count: int, path: str):
    """Split k so that about four blocks per SM are launched; returns
    (splits, rows_per_split). ``path`` is ``int4_path``'s; on "tc" the rows of
    a split are a multiple of 64, so that none of K9's 64-row scale blocks
    straddles two splits."""
    if path == "gemv":
        blocks, step = gn * 4, _GEMV_K_STEP
    elif path == "tc":
        blocks, step = gn * 8 * math.ceil(m / 8), _TC_K_STEP
    else:
        blocks, step = gn * 8 * math.ceil(m / 64), _GEMM_K_STEP
    want = max(1, min(math.ceil(4 * sm_count / blocks), math.ceil(k / step)))
    rows = math.ceil(math.ceil(k / want) / step) * step
    return math.ceil(k / rows), rows


def _launch(x2: torch.Tensor, pw: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            layer: int) -> torch.Tensor:
    """x2 (m, k); pw (L, gk, gn, tk, 128) int32; u (L, k), v (L, n) f32."""
    m, k = x2.shape
    _, gk, gn, tk, lanes = pw.shape
    n = v.shape[1]
    if lanes != 128 or u.shape[1] != k or k > gk * tk or n > gn * INT4_TILE_N:
        raise ValueError(f"shapes x {tuple(x2.shape)} q4r1 {tuple(pw.shape)} "
                         f"u {tuple(u.shape)} v {tuple(v.shape)}")
    for name, a, dt in (("q4r1", pw, torch.int32), ("u4", u, torch.float32),
                        ("v4", v, torch.float32)):
        if a.dtype != dt or not a.is_contiguous() or a.device != x2.device:
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {x2.device}")
    out_dtype = x2.dtype
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    x2 = x2.contiguous()
    path = int4_path(m, tk)
    splits, rows = _splits(m, k, gn, _sm_count(x2.device.index or 0), path)
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    part = torch.empty((splits, m, gn * INT4_TILE_N), dtype=torch.float32, device=x2.device)

    def at(a):
        return a.data_ptr() + layer * a.stride(0) * a.element_size()

    KERNELS["int4_rank1_matmul"].launch(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), m, k, at(u), at(pw), gk, gn, tk,
        at(v), n, y.data_ptr(), part.data_ptr(), splits, rows, int(path == "tc"))
    return y.to(out_dtype)


def int4_matmul_rank1_stacked(x: torch.Tensor, p: dict, layer: int, *,
                              plain: bool = False) -> torch.Tensor:
    """Layer ``layer`` of stacked q4r1 params: q4r1 (L, gk, gn, tk, 128),
    u4 (L, k), v4 (L, n). x (..., k) -> (..., n) in x's dtype."""
    pw, u, v = p["q4r1"], p["u4"], p["v4"]
    layer = int(layer)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, u.shape[1])
    tk = pw.shape[3]
    m_max = max(_INT4_MAX_M, min(512, (28 * 2**20) // (tk * 4)))
    if x2.shape[0] > m_max:
        w = dequantize({"q4r1": pw[layer], "u4": u[layer], "v4": v[layer]}, x.dtype)
        return torch.matmul(x2, w).reshape(*lead, v.shape[1]).to(x.dtype)
    if use_kernel(x2, pw, plain=plain):
        y = _launch(x2, pw, u, v, layer)
    else:
        y = int4_matmul_rank1_plain(x2, pw[layer], u[layer], v[layer])
    return y.reshape(*lead, v.shape[1]).to(x.dtype)


def int4_matmul_rank1(x: torch.Tensor, p: dict, *, plain: bool = False) -> torch.Tensor:
    """One q4r1 linear: q4r1 (gk, gn, tk, 128), u4 (k,), v4 (n,).
    x (..., k) -> (..., n) in x's dtype."""
    pw, u, v = p["q4r1"], p["u4"], p["v4"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, u.shape[0])
    if x2.shape[0] > _INT4_MAX_M:
        return torch.matmul(x2, dequantize(p, x.dtype)).reshape(*lead, v.shape[0]).to(x.dtype)
    if use_kernel(x2, pw, plain=plain):
        y = _launch(x2, pw[None], u[None], v[None], 0)
    else:
        y = int4_matmul_rank1_plain(x2, pw, u, v)
    return y.reshape(*lead, v.shape[0]).to(x.dtype)


# ---------------------------------------------------------------- K9: blockwise int4


def int4_matmul_tiled_plain(x: torch.Tensor, pw_t: torch.Tensor,
                            s_t: torch.Tensor | None = None) -> torch.Tensor:
    """x (m, k_pad) @ tiled int4 (gk, gn, tk, 128) -> (m, n_pad) f32: the
    unpacked codes, each times s * 0.125 of its 64-row block (the raw codes
    without ``s_t``), then one product."""
    w = _unpack_int4_tiled(pw_t)
    if s_t is not None:
        gk, gn, nb, _ = s_t.shape
        s = s_t.permute(0, 2, 1, 3).reshape(gk * nb, gn * INT4_TILE_N) * 0.125
        w = (w.reshape(-1, DEFAULT_BLOCK, w.shape[1]) * s[:, None, :]).reshape(w.shape)
    return torch.matmul(x.float(), w)


def _block_launch(x2: torch.Tensor, pw: torch.Tensor, s_t, n: int, out_dtype) -> torch.Tensor:
    """K9 on x2 (m, k) with k <= k_pad (rows past k count as zeros): the
    first n columns, in ``out_dtype``."""
    m, k = x2.shape
    gk, gn, tk, lanes = pw.shape
    if lanes != 128 or k > gk * tk or n > gn * INT4_TILE_N:
        raise ValueError(f"shapes x {tuple(x2.shape)} q4b {tuple(pw.shape)} n {n}")
    tensors = [("q4b", pw, torch.int32)]
    if s_t is not None:
        if tuple(s_t.shape) != (gk, gn, tk // DEFAULT_BLOCK, INT4_TILE_N):
            raise ValueError(f"scale4 {tuple(s_t.shape)} for q4b {tuple(pw.shape)}")
        tensors.append(("scale4", s_t, torch.float32))
    for name, a, dt in tensors:
        if a.dtype != dt or not a.is_contiguous() or a.device != x2.device:
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {x2.device}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    x2 = x2.contiguous()
    y_bf16 = out_dtype == torch.bfloat16
    path = int4_path(m, tk)
    splits, rows = _splits(m, k, gn, _sm_count(x2.device.index or 0), path)
    y = torch.empty((m, n), dtype=torch.bfloat16 if y_bf16 else torch.float32, device=x2.device)
    part = torch.empty((splits, m, gn * INT4_TILE_N), dtype=torch.float32, device=x2.device)
    KERNELS["int4_block_matmul"].launch(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), m, k, pw.data_ptr(),
        None if s_t is None else s_t.data_ptr(), gk, gn, tk, n, y.data_ptr(), int(y_bf16),
        part.data_ptr(), splits, rows, int(path == "tc"))
    return y.to(out_dtype)


def int4_matmul_tiled(x: torch.Tensor, pw_t: torch.Tensor, s_t: torch.Tensor | None = None, *,
                      plain: bool = False) -> torch.Tensor:
    """x (m, k_pad) @ tiled int4 weights -> (m, n_pad) f32 (B6's function):
    ``s_t`` (gk, gn, tk/64, 1024) scales each weight's 64-row block; without
    it the raw signed nibbles."""
    gk, gn, tk, _ = pw_t.shape
    if x.shape[1] != gk * tk:
        raise ValueError(f"x {tuple(x.shape)} for tiled words {tuple(pw_t.shape)}")
    if use_kernel(x, pw_t, plain=plain):
        return _block_launch(x, pw_t, s_t, gn * INT4_TILE_N, torch.float32)
    return int4_matmul_tiled_plain(x, pw_t, s_t)


def int4_matmul_block(x: torch.Tensor, p: dict, *, plain: bool = False) -> torch.Tensor:
    """One blockwise int4 linear {"q4b", "scale4", "n4", "k4"}: x (..., k) ->
    (..., n) in x's dtype. Rows above ``_INT4_MAX_M`` go to dequantize +
    matmul."""
    pw, s_t = p["q4b"], p["scale4"]
    n = p["n4"].shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    k_pad = pw.shape[0] * pw.shape[2]
    if x2.shape[0] > _INT4_MAX_M:
        return torch.matmul(x2, dequantize(p, x.dtype)).reshape(*lead, n).to(x.dtype)
    if use_kernel(x2, pw, plain=plain):
        y = _block_launch(x2, pw, s_t, n, x.dtype)
    else:
        xs = torch.nn.functional.pad(x2.float(), (0, k_pad - x2.shape[1]))
        y = int4_matmul_tiled_plain(xs, pw, s_t)[:, :n]
    return y.reshape(*lead, n).to(x.dtype)


# ---------------------------------------------------------------- K8: exact 4-bit codebook


def pallas_eligible(p: dict, k_in: int, k_out: int) -> bool:
    """The reference's condition for its fused kernel (B7's tiles); the
    double-quant scales are dequantized before the call."""
    return "q4" in p and k_in % TILE_K == 0 and k_out % TILE_N == 0


def nf4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
                     code: torch.Tensor) -> torch.Tensor:
    """x (m, k) @ 4-bit codes (k/2, n) -> (m, n) f32, as B7 sums: per 64-row
    block ``x_even @ code[hi] + x_odd @ code[lo]``, times the block's
    absmax, added block after block; the blocks of each 512-row k tile
    first, then the tile onto the output."""
    m, k = x.shape
    n = packed.shape[1]
    nb = k // DEFAULT_BLOCK
    xf = x.float()
    xe = xf[:, 0::2].reshape(m, nb, DEFAULT_BLOCK // 2).transpose(0, 1)  # (nb, m, 32)
    xo = xf[:, 1::2].reshape(m, nb, DEFAULT_BLOCK // 2).transpose(0, 1)
    code = code.float()
    am = absmax.float()
    per_tile = TILE_K // DEFAULT_BLOCK
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for t0 in range(0, nb, per_tile):
        t1 = min(t0 + per_tile, nb)
        pk = packed[t0 * 32:t1 * 32].int().reshape(t1 - t0, 32, n)
        pb = torch.bmm(xe[t0:t1], code[pk >> 4]) + torch.bmm(xo[t0:t1], code[pk & 0xF])
        acc = torch.zeros_like(y)
        for i in range(t1 - t0):
            acc += pb[i] * am[t0 + i]
        y += acc
    return y


def nf4_path(m: int) -> str:
    """The kernel of K8 for m rows of x: "gemv" (m <= NF4_GEMV_MAX_M), "tc" (the
    tensor cores, up to NF4_TC_MAX_M) or "fma" (the 64-row f32 tile). With
    NF4_GEMV_MAX_M at 8 the gemv takes m <= 8 again, as before K8 had a
    tensor-core path."""
    if m <= NF4_GEMV_MAX_M:
        return "gemv"
    if m <= NF4_TC_MAX_M:
        return "tc"
    return "fma"


def _nf4_splits(m: int, nb: int, n: int, sm_count: int, path: str):
    """Split the k axis (in whole 64-row quant blocks) so that about four
    blocks per SM are launched; returns (splits, quant blocks per split).
    ``path`` is ``nf4_path``'s: the gemv's 4 row threads each want a quant
    block of every split; the tensor-core kernel takes 8 rows and 256 columns a
    block."""
    if path == "gemv":
        blocks, per = math.ceil(n / 256), 4
    elif path == "tc":
        blocks, per = math.ceil(m / 8) * math.ceil(n / 256), 1
    else:
        blocks, per = math.ceil(m / 64) * math.ceil(n / 128), 1
    want = max(1, min(math.ceil(4 * sm_count / blocks), nb // per))
    bps = math.ceil(nb / want)
    return math.ceil(nb / bps), bps


def _nf4_launch(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor, code: torch.Tensor,
                out_dtype) -> torch.Tensor:
    m, k = x.shape
    n = packed.shape[1]
    for name, a, dt in (("q4", packed, torch.uint8), ("absmax", absmax, torch.float32),
                        ("code", code, torch.float32)):
        if a.dtype != dt or not a.is_contiguous() or a.device != x.device or a.data_ptr() % 16:
            raise ValueError(f"{name}: need a contiguous, 16-byte aligned {dt} tensor on "
                             f"{x.device}")
    if n % 8:
        raise ValueError(f"K8 takes n % 8 == 0, not n = {n}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: the kernels load x in pairs
        x = x.clone()
    y_bf16 = out_dtype == torch.bfloat16
    path = nf4_path(m)
    splits, bps = _nf4_splits(m, k // DEFAULT_BLOCK, n, _sm_count(x.device.index or 0), path)
    y = torch.empty((m, n), dtype=torch.bfloat16 if y_bf16 else torch.float32, device=x.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    KERNELS["nf4_matmul"].launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, packed.data_ptr(), absmax.data_ptr(),
        code.data_ptr(), n, y.data_ptr(), int(y_bf16),
        None if part is None else part.data_ptr(), splits, bps, _NF4_PATHS.index(path))
    return y.to(out_dtype)


def nf4_matmul(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor, code: torch.Tensor,
               *, out_dtype=torch.float32, plain: bool = False) -> torch.Tensor:
    """x (m, k) @ 4-bit codes (k/2, n) u8 with (k/64, n) absmax and a (16,)
    code table -> (m, n), accumulated in f32 and returned in ``out_dtype``
    (B7 returns f32). Any m; k % 64 == 0."""
    m, k = x.shape
    n = packed.shape[1]
    if k % DEFAULT_BLOCK or packed.shape[0] * 2 != k or tuple(absmax.shape) != (
            k // DEFAULT_BLOCK, n) or tuple(code.shape) != (16,):
        raise ValueError(f"shapes x {tuple(x.shape)} q4 {tuple(packed.shape)} absmax "
                         f"{tuple(absmax.shape)} code {tuple(code.shape)}")
    if use_kernel(x, packed, absmax, code, plain=plain):
        return _nf4_launch(x, packed, absmax, code, out_dtype)
    return nf4_matmul_plain(x, packed, absmax, code).to(out_dtype)


def quantized_matmul_pallas(x: torch.Tensor, p: dict, *, plain: bool = False) -> torch.Tensor:
    """One 4-bit linear through ``nf4_matmul``: x (..., k) -> (..., n) in x's
    dtype; double-quant scales are dequantized first."""
    packed = p["q4"]
    k_in, k_out = packed.shape[0] * 2, packed.shape[1]
    lead = x.shape[:-1]
    y = nf4_matmul(x.reshape(-1, k_in), packed, _absmax_of(p, k_in, k_out), p["code"],
                   out_dtype=x.dtype, plain=plain)
    return y.reshape(*lead, k_out)
