"""Wrappers of the kernels of the int4/NF4 labs (``TOOL_KERNELS`` of
``kernels/build.py``), each with its plain PyTorch version beside it:

* K10 ``int4_tiled_bf16``: raw signed nibbles of tiled words times bf16 x on
  the tensor cores, one launch a call (the last block of a column unit to
  finish adds the k splits in order), ``csrc/int4_tiled_bf16.cu``;
* K11 ``q4_byte_matmul``: 4-bit codes in the q4 byte layout through a
  16-entry value table, scaled before the product or per 64-row block,
  ``csrc/q4_byte_matmul.cu``;
* K12 ``colnibble_matmul``: blockwise int4 in the column-nibble layout (the
  lab's v8-v11), ``csrc/int4_colnibble_matmul.cu``;
* K13 ``stream_tiled`` and ``stream_bytes``: the read-rate probes, one
  launch a call, ``csrc/stream_probe.cu``.

K11 and K12 each have a gemv and a tensor-core kernel, chosen by
``lab_path`` from the shape alone. A CUDA tensor goes to the kernel (or the
call raises); a CPU tensor, or ``plain=True``, to the plain version, which
repeats the kernel's arithmetic (where the Pallas code rounds to bf16, both
round). Every output is f32.
"""

from __future__ import annotations

import math

import torch

from ..kernels.build import TOOL_KERNELS, use_kernel
from ..ops.quant import DEFAULT_BLOCK, INT4_TILE_N, _unpack_int4_tiled
from ..ops.quant_kernels import _sm_count

# copies of csrc/int4_tiled_bf16.cu's kSlices, kSplitRows, kMaxSplits and kBlocksPerSm, and
# of csrc/stream_probe.cu's kColThreads, kMaxSplits and kBlocksPerSm (mode 1)
# (tests/test_torch_lab_k10.py holds them)
K10_SLICES, K10_SPLIT_ROWS, K10_MAX_SPLITS, K10_BLOCKS_PER_SM = 8, 64, 8, 6
PROBE_COL_THREADS, PROBE_MAX_SPLITS, PROBE_BLOCKS_PER_SM = 8, 16, 4
LAB_GEMV_MAX_M = 4  # K11 and K12 stream weights for m <= 4 (the gemv takes any m),
LAB_TC_MAX_M = 64   # run the tensor cores up to 64 rows, and the gemv above
_LAB_PATHS = ("gemv", "tc")  # the C entries' path argument, by index


def lab_path(m: int, n: int) -> str:
    """The kernel of K11 and K12 for m rows of x and n columns: "tc" (the
    tensor cores) for LAB_GEMV_MAX_M < m <= LAB_TC_MAX_M where n % 8 == 0
    (K11's 8-byte loads; K12's n is whole 1024-column tiles), else "gemv".
    With LAB_TC_MAX_M at LAB_GEMV_MAX_M every m takes the gemv, as before the
    tensor-core kernels."""
    if LAB_GEMV_MAX_M < m <= LAB_TC_MAX_M and n % 8 == 0:
        return "tc"
    return "gemv"


def _lab_splits(kernel: str, path: str, m: int, k: int, n: int, sm_count: int):
    """(splits, 64-row blocks per split) of a K11 ("q4") or K12 ("colnibble")
    call on ``path``, each split whole 64-row blocks. A launched block takes 8
    rows of x and 256 columns, except K12's tensor-core block: one 16-lane
    unit of a 1024-column tile, 128 columns."""
    cols = 128 if (kernel, path) == ("colnibble", "tc") else 256
    return _splits(math.ceil(n / cols) * math.ceil(m / 8), k, DEFAULT_BLOCK, sm_count)


def _splits(units: int, k: int, step: int, sm_count: int):
    """Split k (in steps of ``step`` rows) so that about four blocks per SM
    are launched over ``units`` blocks a split; returns (splits, steps per
    split)."""
    steps = k // step
    want = max(1, min(math.ceil(4 * sm_count / units), steps))
    per = math.ceil(steps / want)
    return math.ceil(steps / per), per


def _check(name: str, a: torch.Tensor, dtype, device) -> None:
    if a.dtype != dtype or not a.is_contiguous() or a.device != device or a.data_ptr() % 16:
        raise ValueError(f"{name}: need a contiguous, 16-byte aligned {dtype} tensor on {device}")


# ---------------------------------------------------------------- K10


def int4_tiled_bf16_plain(x: torch.Tensor, pw_t: torch.Tensor) -> torch.Tensor:
    """x (m, k_pad) rounded to bf16 @ the raw nibbles of tiled words (gk, gn,
    tk, 128) -> (m, n_pad) f32: each product is exact in f32."""
    return torch.matmul(x.to(torch.bfloat16).float(), _unpack_int4_tiled(pw_t))


_COUNTERS: dict = {}
_MAX_COUNTERS = 1 << 16


def _counters(name: str, device, n: int) -> torch.Tensor:
    """The zeroed int32 counters of ``name``'s kernel on ``device`` (one for each
    unit whose k splits the kernel adds up), made once and kept: each call's
    last block of a unit sets its counter back to zero, so they are zero
    between calls and a CUDA graph's replays find them so. Calls of one kernel
    must not run at once on two streams."""
    if n > _MAX_COUNTERS:
        raise ValueError(f"{name}: {n} counters, at most {_MAX_COUNTERS}")
    key = (name, str(device))
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(_MAX_COUNTERS, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _balanced_splits(units: int, rounds: int, max_splits: int, sm_count: int,
                     per_sm: int):
    """(splits, rounds per split) for ``units`` blocks a split, each streaming
    its rounds: at most ``max_splits``, none empty; the fewest waves of
    ``per_sm`` blocks an SM (each block pays a fixed start and end), then the
    busiest SM streaming the fewest rounds (its ceil(blocks / SMs) blocks times
    the rounds of one), then more splits (more blocks in flight)."""
    best = None
    for want in range(1, min(max_splits, rounds) + 1):
        per = math.ceil(rounds / want)
        splits = math.ceil(rounds / per)
        blocks = units * splits
        key = (math.ceil(blocks / (sm_count * per_sm)), math.ceil(blocks / sm_count) * per,
               -splits)
        if best is None or key < best[0]:
            best = (key, splits, per)
    return best[1], best[2]


def k10_plan(m: int, k: int, gn: int, sm_count: int):
    """(splits, rows per split) of a K10 call over its blocks (``K10_SLICES`` a
    1024-column tile, one a chunk of 8 rows of x): each split whole rounds of
    ``K10_SPLIT_ROWS`` rows (one 16-row step a warp), balanced over the SMs
    (``_balanced_splits``)."""
    units = gn * K10_SLICES * math.ceil(m / 8)
    splits, per = _balanced_splits(units, math.ceil(k / K10_SPLIT_ROWS), K10_MAX_SPLITS,
                                   sm_count, K10_BLOCKS_PER_SM)
    return splits, per * K10_SPLIT_ROWS


def int4_tiled_bf16(x: torch.Tensor, pw_t: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """K10: bf16(x) (m, gk*tk) @ raw signed nibbles (gk, gn, tk, 128) ->
    (m, gn*1024) f32, columns in the packed order."""
    gk, gn, tk, lanes = pw_t.shape
    m, k = x.shape
    if lanes != 128 or k != gk * tk or tk % 16:
        raise ValueError(f"x {tuple(x.shape)} for tiled words {tuple(pw_t.shape)}")
    if not use_kernel(x, pw_t, plain=plain):
        return int4_tiled_bf16_plain(x, pw_t)
    _check("words", pw_t, torch.int32, x.device)
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    splits, rows = k10_plan(m, k, gn, _sm_count(x.device.index or 0))
    units = gn * K10_SLICES * math.ceil(m / 8)
    y = torch.empty((m, gn * INT4_TILE_N), dtype=torch.float32, device=x.device)
    part = torch.empty((units, splits, INT4_TILE_N), dtype=torch.float32, device=x.device)
    counter = _counters("int4_tiled_bf16", x.device, units)
    TOOL_KERNELS["int4_tiled_bf16"].launch(xb.data_ptr(), m, pw_t.data_ptr(), gk, gn, tk,
                                           y.data_ptr(), part.data_ptr(), counter.data_ptr(),
                                           splits, rows)
    return y


# ---------------------------------------------------------------- K11


def _q4_values(packed: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(k/2, n) bytes -> (k, n) table values, row 2r from the high nibble of
    byte row r and row 2r + 1 from the low."""
    b = packed.long()
    vals = torch.stack([table[b >> 4], table[b & 0xF]], dim=1)  # (k/2, 2, n)
    return vals.reshape(-1, packed.shape[1])


def _blockwise(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """sum over 64-row blocks b of (x_b @ w_b) * s[b], in block order."""
    m, k = x.shape
    nb = k // DEFAULT_BLOCK
    part = torch.bmm(x.reshape(m, nb, DEFAULT_BLOCK).transpose(0, 1),
                     w.reshape(nb, DEFAULT_BLOCK, -1))  # (nb, m, n)
    y = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x.device)
    for b in range(nb):
        y += part[b] * s[b]
    return y


def q4_byte_matmul_plain(x, packed, absmax, table, scale_mul: float, per_block: bool):
    vals = _q4_values(packed, table.float())
    s = absmax.float() * scale_mul
    if per_block:
        return _blockwise(x.float(), vals, s)
    w = (vals.reshape(-1, DEFAULT_BLOCK, vals.shape[1]) * s[:, None, :]).reshape(vals.shape)
    return torch.matmul(x.float(), w)


def _f32_x(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels load it: contiguous f32, 16-byte aligned (the tensor-
    core kernels read it in pairs)."""
    xf = x.float().contiguous()
    return xf.clone() if xf.data_ptr() % 16 else xf


def _q4_launch(x, packed, absmax, table, scale_mul: float, per_block: bool,
               bf16: bool) -> torch.Tensor:
    m, k = x.shape
    n = packed.shape[1]
    for name, a, dt in (("q4", packed, torch.uint8), ("absmax", absmax, torch.float32),
                        ("table", table, torch.float32)):
        _check(name, a, dt, x.device)
    xf = _f32_x(x)
    path = lab_path(m, n)
    splits, per = _lab_splits("q4", path, m, k, n, _sm_count(x.device.index or 0))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    TOOL_KERNELS["q4_byte_matmul"].launch(
        xf.data_ptr(), m, k, packed.data_ptr(), absmax.data_ptr(), table.data_ptr(),
        float(scale_mul), int(per_block), n, y.data_ptr(), part.data_ptr(), splits, per,
        int(bf16), _LAB_PATHS.index(path))
    return y


def q4_byte_matmul(x: torch.Tensor, packed: torch.Tensor, absmax: torch.Tensor,
                   table: torch.Tensor, scale_mul: float, per_block: bool, *,
                   bf16: bool = False, plain: bool = False) -> torch.Tensor:
    """K11: x (m, k) f32 (rounded by the caller where the reference rounds) @
    table[codes] of the q4 bytes (k/2, n) u8, each weight times absmax (k/64,
    n) * scale_mul before the product, or each 64-row block's partial after
    it (``per_block``) -> (m, n) f32. ``bf16``: the caller states that x and
    the table values are bf16 numbers (v5-v7), so the tensor-core kernel takes
    one bf16 part of each; else three of the table and two of x."""
    m, k = x.shape
    n = packed.shape[1]
    if (k % DEFAULT_BLOCK or packed.shape[0] * 2 != k or tuple(absmax.shape) != (
            k // DEFAULT_BLOCK, n) or tuple(table.shape) != (16,) or n % 4):
        raise ValueError(f"shapes x {tuple(x.shape)} q4 {tuple(packed.shape)} absmax "
                         f"{tuple(absmax.shape)} table {tuple(table.shape)}")
    if not use_kernel(x, packed, absmax, table, plain=plain):
        return q4_byte_matmul_plain(x, packed, absmax, table, scale_mul, per_block)
    return _q4_launch(x, packed, absmax, table, scale_mul, per_block, bf16)


# ---------------------------------------------------------------- K12

COLNIBBLE_MODES = {"v8": 0, "v9": 1, "v10": 2, "v11": 3}


def _colnibble_codes(pw: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """(k, n/8) words -> (k, n) f32 codes in real column order: nibble p of
    word (r, t*128 + l) is column t*1024 + p*128 + l; ``unsigned``: (c & 0xF)
    - 8, else the two's-complement nibble."""
    k, n8 = pw.shape
    planes = []
    for p in range(8):
        nib = (pw >> (4 * p)) & 0xF
        planes.append(nib - 8 if unsigned else nib - ((nib >> 3) << 4))
    q = torch.stack(planes, dim=2)  # (k, n/8, 8) = (k, t*128 + l, p)
    return q.reshape(k, n8 // 128, 128, 8).permute(0, 1, 3, 2).reshape(k, n8 * 8).float()


def colnibble_matmul_plain(x: torch.Tensor, pw: torch.Tensor, s: torch.Tensor,
                           variant: str) -> torch.Tensor:
    q = _colnibble_codes(pw, variant == "v8")
    s8 = s.float() * 0.125
    if variant == "v11":
        return _blockwise(x.float(), q, s8)
    if variant == "v10":
        sb = s8.to(torch.bfloat16).repeat_interleave(DEFAULT_BLOCK, 0)
        return torch.matmul(x.float(), (q.to(torch.bfloat16) * sb).float())  # rounds to bf16
    return torch.matmul(x.float(), q * s8.repeat_interleave(DEFAULT_BLOCK, 0))


def _colnibble_launch(x, pw, s, variant: str) -> torch.Tensor:
    m, k = x.shape
    n = pw.shape[1] * 8
    _check("pw", pw, torch.int32, x.device)
    _check("s", s, torch.float32, x.device)
    xf = _f32_x(x)
    path = lab_path(m, n)
    splits, per = _lab_splits("colnibble", path, m, k, n, _sm_count(x.device.index or 0))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    TOOL_KERNELS["int4_colnibble_matmul"].launch(
        xf.data_ptr(), m, k, pw.data_ptr(), s.data_ptr(), n, COLNIBBLE_MODES[variant],
        y.data_ptr(), part.data_ptr(), splits, per, _LAB_PATHS.index(path))
    return y


def colnibble_matmul(x: torch.Tensor, pw: torch.Tensor, s: torch.Tensor, variant: str, *,
                     plain: bool = False) -> torch.Tensor:
    """K12: x (m, k) f32 (rounded to bf16 by the caller for v10 and v11) @
    the column-nibble words (k, n/8) int32 with scales s (k/64, n) ->
    (m, n) f32, ``variant`` one of v8, v9, v10, v11."""
    m, k = x.shape
    n = pw.shape[1] * 8
    if variant not in COLNIBBLE_MODES or k % DEFAULT_BLOCK or pw.shape[0] != k or n % 1024 or \
            tuple(s.shape) != (k // DEFAULT_BLOCK, n):
        raise ValueError(f"{variant}: shapes x {tuple(x.shape)} pw {tuple(pw.shape)} s "
                         f"{tuple(s.shape)}")
    if not use_kernel(x, pw, s, plain=plain):
        return colnibble_matmul_plain(x, pw, s, variant)
    return _colnibble_launch(x, pw, s, variant)


# ---------------------------------------------------------------- K13


def stream_tiled_plain(pw_t: torch.Tensor) -> torch.Tensor:
    gk, gn, _, _ = pw_t.shape
    out = torch.zeros((gn, INT4_TILE_N), dtype=torch.float32, device=pw_t.device)
    for j in range(gk):
        out[:, :128] += pw_t[j, :, 0, :].float()
    return out.reshape(1, gn * INT4_TILE_N)


def stream_tiled(pw_t: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """K13 (stream_ref): tiled words (gk, gn, tk, 128) -> (1, gn*1024) f32:
    at column 1024 i + l, l < 128, the sum over j in order of f32(pw_t[j, i,
    0, l]); zeros elsewhere. The kernel loads every word."""
    gk, gn, tk, lanes = pw_t.shape
    if lanes != 128:
        raise ValueError(f"tiled words {tuple(pw_t.shape)}")
    if not use_kernel(pw_t, plain=plain):
        return stream_tiled_plain(pw_t)
    _check("words", pw_t, torch.int32, pw_t.device)
    out = torch.empty((1, gn * INT4_TILE_N), dtype=torch.float32, device=pw_t.device)
    blocks = 2 * _sm_count(pw_t.device.index or 0)
    checksum = torch.empty(blocks, dtype=torch.int32, device=pw_t.device)
    TOOL_KERNELS["stream_probe"].launch(0, pw_t.data_ptr(), pw_t.numel(), tk, gn, gk, None,
                                        out.data_ptr(), blocks, 0, checksum.data_ptr(), None,
                                        None)
    return out


def probe_plan(n: int, tiles: int, sm_count: int):
    """(splits, tiles per split, strips) of a stream_bytes call: strips of
    ``PROBE_COL_THREADS`` 16-byte loads across (4-byte where n % 16 != 0), the
    tiles split as ``_balanced_splits`` does, at most ``PROBE_MAX_SPLITS``."""
    strips = math.ceil(n / (PROBE_COL_THREADS * (16 if n % 16 == 0 else 4)))
    splits, per = _balanced_splits(strips, tiles, PROBE_MAX_SPLITS, sm_count,
                                   PROBE_BLOCKS_PER_SM)
    return splits, per, strips


def stream_bytes_plain(packed: torch.Tensor, absmax: torch.Tensor, tk: int) -> torch.Tensor:
    k2, n = packed.shape
    out = torch.zeros((1, n), dtype=torch.float32, device=packed.device)
    for j in range((2 * k2) // tk):
        cs = packed[j * tk // 2:(j + 1) * tk // 2].int().sum(0).float()
        out += cs + absmax[j * tk // 64].float()
    return out


def stream_bytes(packed: torch.Tensor, absmax: torch.Tensor, tk: int = 512, tn: int = 256, *,
                 plain: bool = False) -> torch.Tensor:
    """K13 (stream_bytes): q4 bytes (k/2, n) u8 and absmax (k/64, n) over the
    (2 k2) // tk row tiles the Pallas grid covers -> (1, n) f32, the sum over
    tiles j in order of f32(column sums of tile j's bytes) + absmax[j tk/64].
    The kernel loads every byte of those tiles and their absmax rows."""
    k2, n = packed.shape
    if tk % 64 or tn <= 0 or n % tn or n % 4 or absmax.shape[1] != n or \
            not 0 < (2 * k2) // tk * tk <= absmax.shape[0] * 64:
        raise ValueError(f"q4 {tuple(packed.shape)} absmax {tuple(absmax.shape)} tk {tk} "
                         f"tn {tn}")
    if not use_kernel(packed, absmax, plain=plain):
        return stream_bytes_plain(packed, absmax, tk)
    _check("q4", packed, torch.uint8, packed.device)
    _check("absmax", absmax, torch.float32, packed.device)
    tiles = (2 * k2) // tk
    splits, per, strips = probe_plan(n, tiles, _sm_count(packed.device.index or 0))
    out = torch.empty((1, n), dtype=torch.float32, device=packed.device)
    checksum = torch.empty(splits * strips, dtype=torch.int32, device=packed.device)
    vals = torch.empty((tiles, n), dtype=torch.float32, device=packed.device)
    counter = _counters("stream_probe", packed.device, strips)
    TOOL_KERNELS["stream_probe"].launch(1, packed.data_ptr(), 0, tk, n, tiles, absmax.data_ptr(),
                                        out.data_ptr(), splits, per, checksum.data_ptr(),
                                        vals.data_ptr(), counter.data_ptr())
    return out
