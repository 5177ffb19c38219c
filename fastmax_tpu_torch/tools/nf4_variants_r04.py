"""Candidate NF4 / int4 fused dequantize + matmul variants of the round-4 lab
(counterpart of ``tools/nf4_variants_r04.py``).

Each variant is ``get*(...) -> f(x, w)`` with the reference's tiles and
arguments, w a dict of the variant's weights; every output is f32 (m, n).
Where two variants compute the same function they share a kernel:

  v1/v2  exact NF4 on the q4 bytes, each weight scaled before the product:
         K11 (``lab_kernels.q4_byte_matmul``), f32 code values
  v3/v4  exact NF4, each 64-row block's partial scaled: K8
         (``ops/quant_kernels.nf4_matmul``; it takes k % 64, so k = 11008)
  v5     v4 with bf16 code values and bf16 x: K11
  v6/v7  linear int4 (c - 8) * absmax / 8 on the q4 bytes, x rounded to bf16;
         v6 scaled before the product in f32, v7 per block in bf16: K11
  v8-v11 blockwise int4 in the column-nibble layout (``pack_v8``/``pack_v9``):
         K12 (``lab_kernels.colnibble_matmul``)
  v9t    v9 on ``pack_v9t``'s tiled blocks; at tn = 1024 this is B6's scaled
         function: K9 (``ops/quant_kernels.int4_matmul_tiled``)
  v12    ((x u) @ Q) v / 8 on tiled words: f32 is K1's function
         (``int4_matmul_rank1``), bf16 K10 on bf16(x u) (``int4_tiled_bf16``)

The tile halving of ``get`` (tk, tn halved until they divide k, n) is kept,
and so are the reference's shape conditions: a shape it asserts on raises
``ValueError`` here, and so does one whose weights' tiles do not match the
call's (the Pallas grid would read a part of them; see ROADMAP.md's reference
hazards). The packers are numpy copies of the script's, equal bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import quant_kernels
from ..ops.quant import NF4_CODE
from . import lab_kernels


def _require(cond: bool, what) -> None:
    if not cond:
        raise ValueError(f"shape condition of the reference fails: {what}")


def _halve(size: int, full: int) -> int:
    if size > full:
        size = full
    while full % size:
        size //= 2
    return size


@functools.lru_cache(maxsize=None)
def _table(values: tuple, device: torch.device) -> torch.Tensor:
    """A 16-entry value table on ``device``, made once per device: a copy
    from the host cannot be captured in a CUDA graph, so the timers' warm-up
    call makes it before the capture."""
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


# ---------------------------------------------------------------- v1-v5: exact NF4


def _run(variant, x, packed, absmax, code_vals, tk, tn, *, plain: bool = False):
    """x (m, k) @ NF4 codes (k/2, n) u8 with absmax (k/64, n) -> (m, n) f32."""
    m, k = x.shape
    n = packed.shape[1]
    _require(k % tk == 0 and n % tn == 0, (k, n, tk, tn))
    if variant in ("v3", "v4"):
        return quant_kernels.nf4_matmul(x.float(), packed, absmax,
                                        _table(code_vals, x.device), plain=plain)
    if variant in ("v1", "v2"):
        return lab_kernels.q4_byte_matmul(x.float(), packed, absmax, _table(code_vals, x.device),
                                          1.0, False, plain=plain)
    if variant == "v5":  # bf16 code values and bf16 x, per-block partials
        table = _table(code_vals, x.device).to(torch.bfloat16).float()
        return lab_kernels.q4_byte_matmul(x.to(torch.bfloat16).float(), packed, absmax, table,
                                          1.0, True, bf16=True, plain=plain)
    raise ValueError(variant)


def get(name, k, n, tk=512, tn=256, *, plain: bool = False):
    tk = _halve(tk, k)
    while n % tn:
        tn //= 2
    code_vals = tuple(float(v) for v in NF4_CODE)

    def f(x, w):
        return _run(name, x, w["q4"], w["absmax"], code_vals, tk, tn, plain=plain)

    return f


# ---------------------------------------------------------------- v6/v7: int4 linear


_INT4_LEVELS = tuple(float(c - 8) for c in range(16))


def _run_int4(variant, x, packed, absmax, tk, tn, *, plain: bool = False):
    """Linear int4 on the q4 bytes: level (c - 8) * absmax / 8, x rounded to
    bf16 -> (m, n) f32."""
    m, k = x.shape
    n = packed.shape[1]
    _require(k % tk == 0 and n % tn == 0, (k, n, tk, tn))
    xb = x.to(torch.bfloat16).float()
    return lab_kernels.q4_byte_matmul(xb, packed, absmax, _table(_INT4_LEVELS, x.device), 0.125,
                                      variant == "v7", bf16=True, plain=plain)


def get_int4(name, k, n, tk=2048, tn=512, *, plain: bool = False):
    tk = _halve(tk, k)
    while n % tn:
        tn //= 2

    def f(x, w):
        return _run_int4(name, x, w["q4"], w["absmax"], tk, tn, plain=plain)

    return f


# ------------------------------------------------- v8: u32 column-nibble pack

def pack_v8(q_codes, absmax, tn=1024):
    """Pack int4 codes (k, n) uint8 in [0,16) into u32 words along N.

    Within each tn-column tile, word lane l (of 128) at k-row r packs the 8
    codes of real columns {tile_base + p*128 + l : p in 0..7} in nibble p.
    absmax (k/64, n) is column-permuted identically.
    """
    k, n = q_codes.shape
    assert n % tn == 0 and tn % 128 == 0
    ntile = n // tn
    q = q_codes.astype(np.uint32).reshape(k, ntile, 8, 128)  # [k, t, p, l]
    words = np.zeros((k, ntile, 128), np.uint32)
    for p in range(8):
        words |= q[:, :, p, :] << (4 * p)
    pw = words.reshape(k, ntile * 128).view(np.int32)
    am = absmax.reshape(absmax.shape[0], ntile, 8, 128).reshape(absmax.shape[0], n)
    return pw, am


def _run_colnibble(variant, x, pw, s_perm, tk, tn, *, plain: bool = False):
    m, k = x.shape
    n = pw.shape[1] * 8
    _require(k % tk == 0 and n % tn == 0, (k, n, tk, tn))
    _require(tn == 1024, f"tn {tn}: the column-nibble kernel takes 1024-column tiles")
    xv = x.float() if variant in ("v8", "v9") else x.to(torch.bfloat16).float()
    return lab_kernels.colnibble_matmul(xv, pw, s_perm, variant, plain=plain)


def _run_v8(x, pw, s_perm, tk, tn, *, plain: bool = False):
    return _run_colnibble("v8", x, pw, s_perm, tk, tn, plain=plain)


def get_v8(k, n, tk=2048, tn=1024, *, plain: bool = False):
    tk = _halve(tk, k)

    def f(x, w):
        return _run_v8(x, w["pw"], w["s"], tk, tn, plain=plain)

    return f


# ------------------------------------------- v9: signed-nibble 2-shift unpack

def pack_v9(q_codes, absmax, tn=1024):
    """Like pack_v8 but nibbles stored as two's-complement (q-8), so the
    kernel extracts signed values with left-shift + arithmetic-right-shift
    (no mask, no subtract)."""
    signed = (q_codes.astype(np.int32) - 8) & 0xF
    return pack_v8(signed.astype(np.uint8), absmax, tn)


def _run_v9(x, pw, s_perm, tk, tn, *, plain: bool = False):
    return _run_colnibble("v9", x, pw, s_perm, tk, tn, plain=plain)


def get_v9(k, n, tk=2048, tn=1024, *, plain: bool = False):
    tk = _halve(tk, k)

    def f(x, w):
        return _run_v9(x, w["pw"], w["s"], tk, tn, plain=plain)

    return f


# --------------------------------- v10/v11: shaving the per-weight VPU work


def _run_v10(variant, x, pw, s_perm, tk, tn, *, plain: bool = False):
    """v10: bf16 x, w = bf16(bf16(q) * bf16(s/8)); v11: bf16 x . q per 64-row
    block, the partial times s/8 in f32."""
    if variant not in ("v10", "v11"):
        raise ValueError(variant)
    return _run_colnibble(variant, x, pw, s_perm, tk, tn, plain=plain)


def get_v10(variant, k, n, tk=2048, tn=1024, *, plain: bool = False):
    tk = _halve(tk, k)

    def f(x, w):
        return _run_v10(variant, x, w["pw"], w["s"], tk, tn, plain=plain)

    return f


# --------------------------------------------- v9t: v9 on tiled-block layout

def pack_v9t(q_codes, absmax, tk=2048, tn=1024):
    """pack_v9 + reorder into per-grid-step contiguous blocks:
    pw_t (k/tk, n/tn, tk, tn//8) int32, s_t (k/tk, n/tn, tk//64, tn) f32."""
    pw, s = pack_v9(q_codes, absmax, tn)
    k = pw.shape[0]
    n = pw.shape[1] * 8
    gk, gn = k // tk, n // tn
    pw_t = pw.reshape(gk, tk, gn, tn // 8).transpose(0, 2, 1, 3).copy()
    nb = tk // 64
    s_t = s.reshape(gk, nb, gn, tn).transpose(0, 2, 1, 3).copy()
    return pw_t, s_t


def _run_v9t(x, pw_t, s_t, tk, tn, *, plain: bool = False):
    """v9 on the tiled blocks: B6's scaled function at tn = 1024 (K9). The
    call's tk must be the blocks' and x must cover them."""
    m, k = x.shape
    gk, gn = pw_t.shape[0], pw_t.shape[1]
    _require(tn == 1024 and pw_t.shape[2] == tk and pw_t.shape[3] == tn // 8
             and tuple(s_t.shape) == (gk, gn, tk // 64, tn),
             f"blocks {tuple(pw_t.shape)} / {tuple(s_t.shape)} for tk {tk} tn {tn}")
    _require(k == gk * tk, f"x {tuple(x.shape)} for {gk} k tiles of {tk}")
    return quant_kernels.int4_matmul_tiled(x.float(), pw_t, s_t, plain=plain)


def get_v9t(k, n, tk=2048, tn=1024, *, plain: bool = False):
    tk = _halve(tk, k)

    def f(x, w):
        return _run_v9t(x, w["pw"], w["s"], tk, tn, plain=plain)

    return f


# ----------------------------- v12: rank-1 scale, 3-op/weight tiled kernel


def _run_v12(x, pw_t, u, v, tk, tn, bf16=False, *, plain: bool = False):
    """y = ((x * u_rows) @ Q) * v_cols / 8, Q = signed nibbles: f32 through K1
    (its function exactly), bf16 through K10 on bf16(x * u)."""
    m, k = x.shape
    gk, gn = pw_t.shape[0], pw_t.shape[1]
    _require(tn == 1024 and pw_t.shape[2] == tk and k == gk * tk == u.shape[0],
             f"x {tuple(x.shape)} for tiled words {tuple(pw_t.shape)} at tk {tk} tn {tn}")
    _require(v.shape[0] == gn * tn, f"v {tuple(v.shape)} for {gn} column tiles")
    if not bf16:
        y = quant_kernels.int4_matmul_rank1(x.float(), {"q4r1": pw_t, "u4": u, "v4": v},
                                            plain=plain)
        return y.float()
    xs = x.float() * u[None, :]
    y = lab_kernels.int4_tiled_bf16(xs, pw_t, plain=plain)
    return y * (v[None, :] * 0.125)


def get_v12(k, n, tk=2048, tn=1024, bf16=False, *, plain: bool = False):
    tk = _halve(tk, k)

    def f(x, w):
        return _run_v12(x, w["pw"], w["u"], w["v"], tk, tn, bf16, plain=plain)

    return f


def rank1_envelope(absmax, iters=8):
    """Minimal-ish rank-1 envelope u (x) v >= absmax (per k-block x column)."""
    nb, n = absmax.shape
    u = np.maximum(absmax.max(axis=1), 1e-12)
    for _ in range(iters):
        v = np.max(absmax / u[:, None], axis=0)
        u = np.max(absmax / v[None, :], axis=1)
    return u.astype(np.float32), v.astype(np.float32)
