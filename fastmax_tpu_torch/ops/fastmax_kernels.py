"""Causal fastmax as a chunked prefix scan (counterpart of
``fastmax_tpu/ops/fastmax_pallas.py``).

A CUDA tensor goes to the hand-written kernels ``csrc/fastmax_fwd.cu`` (K4;
``fwd_path`` picks its tensor-core or FMA kernel) and ``csrc/fastmax_bwd.cu``
(K5; ``bwd_path`` likewise); a CPU tensor, or ``plain=True``, goes to
``fastmax_fwd_plain`` and ``fastmax_bwd_plain``, which walk the same chunks
with the same state:

  forward, chunk by chunk (s = q . k / z, f(s) = 1 + s (+ s^2 / 2 for p = 2)):
    f = f(s)_causal v + s_v + q s_kv / z + (Q2 w) S3 / (2 z^2)
    g = rowsum f(s)_causal + cnt + q s_k / z + rowsum((q s_kk) q) / (2 z^2)
    o = f / g;  then the state takes the chunk (s_v, s_kv, s_k, s_kk, S3, cnt)
  backward, last chunk first: rewind the state by subtraction, the chunk's
    VJP against the rewound state and the incoming cotangents, then the
    cotangents take the chunk.

S3 is packed over pairs m <= j (row p = (m, j), upper triangle in row-major
order), with weight w = 2 off the diagonal where the reference weights the
pair features, and padded to ``sym_width(d)`` rows as the reference pads it.
The pair operands are rounded to the input's type where the reference
rounds them (its interpret-mode ``_pair_dtype``): float32 inputs give exact
float32 pair math, bfloat16 inputs round the pair features, the S3 operand
and df to bfloat16. Every sum is float32.

``fastmax_trainable`` is the autograd pair (the reference's
``fastmax_pallas_trainable``); ``fastmax_forward`` is the forward alone (the
reference's ``fastmax_pallas``). Both take (B, H, N, D) with N % chunk == 0,
chunk % 64 == 0 and D <= 64; ``ops/fastmax.py`` pads ragged N.
"""

from __future__ import annotations

import math

import torch

from ..kernels.build import KERNELS, use_kernel

DEFAULT_CHUNK = 128
MAX_D = 64          # the head sizes the kernels take (the reference's d <= 64 gate)
KERNEL_ROWS = 64    # the kernels' row tile: a chunk is a multiple of it
PAIR_TILE = 64      # the kernels' pairs per tile: a split takes whole tiles


def sym_width(d: int) -> int:
    """Packed pair count d (d + 1) / 2, rounded up to 128 (the reference's padding)."""
    return -(-(d * (d + 1) // 2) // 128) * 128


def _pairs(d: int, device):
    """(m, j, w) of the packed pairs, w = 2 off the diagonal and 1 on it."""
    pm, pj = torch.triu_indices(d, d, device=device)
    w = torch.where(pm == pj, 1.0, 2.0).to(device)
    return pm, pj, w


def _pair_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round a float32 pair operand to the input's type (identity for float32)."""
    return x.to(torch.bfloat16).float() if dtype == torch.bfloat16 else x


def _check(q, k, v, p: int, chunk: int):
    if p not in (1, 2):
        raise ValueError(f"p should be 1 or 2, got p={p}")
    bh, n, d = q.shape
    if tuple(k.shape) != (bh, n, d) or tuple(v.shape) != (bh, n, d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d > MAX_D:
        raise NotImplementedError(f"the fastmax kernels take head sizes up to {MAX_D}, not {d}")
    if chunk < KERNEL_ROWS or chunk % KERNEL_ROWS or n % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of {KERNEL_ROWS} dividing N={n}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernels take one of "
                        "float32 or bfloat16")


# ------------------------------------------------------------------ plain versions


def fastmax_fwd_plain(q, k, v, p: int, z: float, chunk: int):
    """q, k, v (BH, N, D). Returns o (BH, N, D) in q's dtype, g (BH, N, 1) f32
    and the final state (s_kv (BH, D, D), s_k (BH, 1, D), s_kkv (BH, sym_width, D),
    s_kk (BH, D, D)); for p = 1 s_kkv is (BH, 1, D) and s_kk (BH, 1, 1), zeros."""
    _check(q, k, v, p, chunk)
    bh, n, d = q.shape
    dt, dev = q.dtype, q.device
    z2 = 2.0 * z * z
    qf, kf, vf = q.float(), k.float(), v.float()
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    s_v = torch.zeros((bh, 1, d), device=dev)
    s_kv = torch.zeros((bh, d, d), device=dev)
    s_k = torch.zeros((bh, 1, d), device=dev)
    s_kk = torch.zeros((bh, d, d), device=dev)
    if p == 2:
        pm, pj, w = _pairs(d, dev)
        s3 = torch.zeros((bh, pm.numel(), d), device=dev)
    o = torch.empty_like(q)
    g = torch.empty((bh, n, 1), device=dev)
    for c0 in range(0, n, chunk):
        qi, ki, vi = (x[:, c0:c0 + chunk] for x in (qf, kf, vf))
        s = qi @ ki.transpose(1, 2) / z
        fs = 1.0 + s
        if p == 2:
            fs = fs + 0.5 * s * s
        fs = torch.where(causal, fs, torch.zeros_like(fs))
        f = fs @ vi + s_v + qi @ s_kv / z
        gi = fs.sum(-1, keepdim=True) + float(c0) + qi @ s_k.transpose(1, 2) / z
        if p == 2:
            gi = gi + ((qi @ s_kk) * qi).sum(-1, keepdim=True) / z2
            q2w = _pair_round(qi[..., pm] * qi[..., pj] * w, dt)
            f = f + q2w @ _pair_round(s3, dt) / z2
        o[:, c0:c0 + chunk] = (f / gi).to(dt)
        g[:, c0:c0 + chunk] = gi
        s_v = s_v + vi.sum(1, keepdim=True)
        s_kv = s_kv + ki.transpose(1, 2) @ vi
        s_k = s_k + ki.sum(1, keepdim=True)
        if p == 2:
            s_kk = s_kk + ki.transpose(1, 2) @ ki
            k2 = _pair_round(ki[..., pm] * ki[..., pj], dt)
            s3 = s3 + k2.transpose(1, 2) @ _pair_round(vi, dt)
    if p == 2:
        s_kkv = torch.zeros((bh, sym_width(d), d), device=dev)
        s_kkv[:, :s3.shape[1]] = s3
    else:
        s_kkv = torch.zeros((bh, 1, d), device=dev)
        s_kk = torch.zeros((bh, 1, 1), device=dev)
    return o, g, (s_kv, s_k, s_kkv, s_kk)


def fastmax_bwd_plain(q, k, v, do, o, g, state, p: int, z: float, chunk: int):
    """The reverse chunk walk: (dq, dk, dv) in q's dtype from the forward's
    o, g and final state (as ``fastmax_fwd_plain`` returns them)."""
    _check(q, k, v, p, chunk)
    bh, n, d = q.shape
    dt, dev = q.dtype, q.device
    z2 = 2.0 * z * z
    qf, kf, vf, dof, of = (x.float() for x in (q, k, v, do, o))
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    s_kv, s_k, s_kkv, s_kk = (x.float().clone() for x in state)
    d_sv = torch.zeros((bh, 1, d), device=dev)
    d_skv = torch.zeros((bh, d, d), device=dev)
    d_sk = torch.zeros((bh, 1, d), device=dev)
    if p == 2:
        pm, pj, w = _pairs(d, dev)
        s3 = s_kkv[:, :pm.numel()].clone()
        d_s3 = torch.zeros_like(s3)
        d_skk = torch.zeros((bh, d, d), device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for c0 in range(n - chunk, -1, -chunk):
        sl = slice(c0, c0 + chunk)
        qi, ki, vi, doi, oi, gi = qf[:, sl], kf[:, sl], vf[:, sl], dof[:, sl], of[:, sl], g[:, sl]
        # rewind the non-S3 state to the chunk's entry value
        s_kv = s_kv - ki.transpose(1, 2) @ vi
        s_k = s_k - ki.sum(1, keepdim=True)
        if p == 2:
            s_kk = s_kk - ki.transpose(1, 2) @ ki
        df = doi / gi
        dgr = -(doi * oi).sum(-1, keepdim=True) / gi
        # intra-chunk VJP
        s = qi @ ki.transpose(1, 2) / z
        fs = 1.0 + s
        fsp = torch.ones_like(s)
        if p == 2:
            fs = fs + 0.5 * s * s
            fsp = fsp + s
        zero = torch.zeros_like(s)
        fs, fsp = torch.where(causal, fs, zero), torch.where(causal, fsp, zero)
        ds = (df @ vi.transpose(1, 2) + dgr) * fsp
        gq = ds @ ki / z
        gk = ds.transpose(1, 2) @ qi / z
        gv = fs.transpose(1, 2) @ df
        # inter-chunk q-side terms against the rewound state
        gq = gq + df @ s_kv.transpose(1, 2) / z
        gq = gq + dgr * s_k / z
        if p == 2:
            gq = gq + dgr * (qi @ s_kk) / (z * z)
        # update-path terms with the incoming cotangents
        gv = gv + d_sv
        gk = gk + vi @ d_skv.transpose(1, 2)
        gv = gv + ki @ d_skv
        gk = gk + d_sk
        if p == 2:
            gk = gk + ki @ d_skk + ki @ d_skk.transpose(1, 2)
            k2 = _pair_round(ki[..., pm] * ki[..., pj], dt)
            vp = _pair_round(vi, dt)
            s3 = s3 - k2.transpose(1, 2) @ vp                  # rewind S3
            s3p = _pair_round(s3, dt)
            qa, qb = qi[..., pm], qi[..., pj]
            dfp = _pair_round(df, dt)
            dq2 = dfp @ s3p.transpose(1, 2) * w                # (C, P)
            gq = gq + (_fold(_pair_round(dq2 * qb, dt), pm, d)
                       + _fold(_pair_round(dq2 * qa, dt), pj, d)) / z2
            ds3p = _pair_round(d_s3, dt)
            dk2 = vp @ ds3p.transpose(1, 2)
            gk = gk + (_fold(_pair_round(dk2 * ki[..., pj], dt), pm, d)
                       + _fold(_pair_round(dk2 * ki[..., pm], dt), pj, d))
            gv = gv + k2 @ ds3p
            q2w = _pair_round(qa * qb * w, dt)
            d_s3 = d_s3 + q2w.transpose(1, 2) @ dfp / z2
        # non-S3 cotangents take the chunk
        d_sv = d_sv + df.sum(1, keepdim=True)
        d_skv = d_skv + qi.transpose(1, 2) @ df / z
        d_sk = d_sk + (dgr * qi).sum(1, keepdim=True) / z
        if p == 2:
            d_skk = d_skk + qi.transpose(1, 2) @ (dgr * qi) / z2
        dq[:, sl], dk[:, sl], dv[:, sl] = gq.to(dt), gk.to(dt), gv.to(dt)
    return dq, dk, dv


def _fold(x: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    """Sum the pair columns of x (BH, C, P) into head columns idx[p]:
    the reference's product with a 0/1 expansion basis transposed."""
    out = torch.zeros(x.shape[:-1] + (d,), device=x.device)
    return out.index_add_(-1, idx, x)


# ------------------------------------------------------------------ kernels


def _nsplit(p: int, d: int, bh: int, device) -> int:
    """CTAs a head: the p = 2 pair terms are split over up to four CTAs a head
    while the heads alone leave SMs idle (32 heads on 132 SMs: four), when
    there are at least eight tiles of pairs to share."""
    tiles = -(-(d * (d + 1) // 2) // PAIR_TILE)
    if p != 2 or tiles < 8:
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(4, sms // bh))


def fwd_path(p: int, d: int) -> str:
    """K4's kernel: "tc" (``fastmax_fwd_tc_kernel``, every product on the
    tensor cores) for p = 2 at D % 16 == 0, "fma" (``fastmax_fwd_kernel``,
    f32 FMAs) otherwise."""
    return "tc" if p == 2 and d % 16 == 0 else "fma"


def bwd_path(p: int, d: int) -> str:
    """K5's kernel: "tc" (``fastmax_bwd_tc_kernel``, every product on the
    tensor cores) for p = 2 at D % 16 == 0, "fma" (``fastmax_bwd_kernel``,
    f32 FMAs) otherwise."""
    return "tc" if p == 2 and d % 16 == 0 else "fma"


def _path_nsplit(path: str, p: int, d: int, bh: int, device) -> int:
    """CTAs a head for K4 or K5. Their tensor-core kernels give CTA 0 the
    work outside the pair terms and split the pairs over up to three more, in
    whole tiles, while the heads alone leave SMs idle; the FMA kernels as
    ``_nsplit``."""
    if path != "tc":
        return _nsplit(p, d, bh, device)
    tiles = -(-(d * (d + 1) // 2) // PAIR_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 1 + max(1, min(3, tiles, sms // bh - 1))


def _fwd_launch(q, k, v, p: int, z: float, chunk: int, train: bool, path: str | None = None):
    """K4. ``path`` ("tc" or "fma") overrides ``fwd_path``'s choice, to time
    both kernels on the same inputs; the C entry refuses a tc call the kernel
    does not take."""
    _check(q, k, v, p, chunk)
    bh, n, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = q.device
    path = path or fwd_path(p, d)
    nsplit = _path_nsplit(path, p, d, bh, dev)
    o = torch.empty_like(q)
    rows = sym_width(d) if p == 2 else 1
    s3 = torch.zeros((bh, rows, d), device=dev) if p == 2 or train else None
    g = torch.empty((bh, n, 1), device=dev) if train or nsplit > 1 else None
    fpart = torch.empty((nsplit, bh, n, d), device=dev) if nsplit > 1 else None
    s_kv = s_k = s_kk = None
    if train:
        s_kv = torch.empty((bh, d, d), device=dev)
        s_k = torch.empty((bh, 1, d), device=dev)
        s_kk = torch.empty((bh, d, d), device=dev) if p == 2 else torch.zeros((bh, 1, 1),
                                                                              device=dev)
    KERNELS["fastmax_fwd"].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
        _ptr(g), _ptr(s_kv), _ptr(s_k), _ptr(s3) if p == 2 else None,
        _ptr(s_kk) if p == 2 else None, _ptr(fpart), bh, n, d, chunk, int(p == 2), float(z),
        rows, nsplit, int(path == "tc"))
    if not train:
        return o
    return o, g, (s_kv, s_k, s3, s_kk)


def _bwd_launch(q, k, v, do, o, g, state, p: int, z: float, chunk: int,
                path: str | None = None):
    """K5. ``path`` ("tc" or "fma") overrides ``bwd_path``'s choice, to time
    both kernels on the same inputs; the C entry refuses a tc call the kernel
    does not take."""
    _check(q, k, v, p, chunk)
    bh, n, d = q.shape
    s_kv, s_k, s_kkv, s_kk = state
    rows = sym_width(d) if p == 2 else 1
    want = {"do": (do, q.dtype, (bh, n, d)), "o": (o, q.dtype, (bh, n, d)),
            "g": (g, torch.float32, (bh, n, 1)), "s_kv": (s_kv, torch.float32, (bh, d, d)),
            "s_k": (s_k, torch.float32, (bh, 1, d)),
            "s_kkv": (s_kkv, torch.float32, (bh, rows, d)),
            "s_kk": (s_kk, torch.float32, (bh, d, d) if p == 2 else (bh, 1, 1))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, the kernel "
                             f"takes {dtype} {shape} on {q.device}")
    q, k, v, do, o, g = (x.contiguous() for x in (q, k, v, do, o, g))
    s_kv, s_k, s_kk = s_kv.contiguous(), s_k.contiguous(), s_kk.contiguous()
    path = path or bwd_path(p, d)
    nsplit = _path_nsplit(path, p, d, bh, q.device)
    s3 = s_kkv.clone() if p == 2 else None           # rewound in place by the kernel
    ds3 = torch.zeros_like(s_kkv) if p == 2 else None
    part = torch.zeros((nsplit, 3, bh, n, d), device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    KERNELS["fastmax_bwd"].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), g.data_ptr(), s_kv.data_ptr(), s_k.data_ptr(),
        _ptr(s_kk) if p == 2 else None, _ptr(s3), _ptr(ds3), part.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, n, d, chunk, int(p == 2), float(z), rows, nsplit,
        int(path == "tc"))
    return dq, dk, dv


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------------ entry points


class _Fastmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, p, z, chunk, plain):
        b, h, n, d = q.shape
        qf, kf, vf = (x.reshape(b * h, n, d) for x in (q, k, v))
        ctx.kernel = use_kernel(q, k, v, plain=plain)
        if ctx.kernel:
            o, g, state = _fwd_launch(qf, kf, vf, p, z, chunk, train=True)
        else:
            o, g, state = fastmax_fwd_plain(qf, kf, vf, p, z, chunk)
        ctx.p, ctx.z, ctx.chunk = p, z, chunk
        ctx.save_for_backward(qf, kf, vf, o, g, *state)
        return o.reshape(b, h, n, d)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, g, *state = ctx.saved_tensors
        b, h, n, d = do.shape
        dof = do.reshape(b * h, n, d).to(qf.dtype)
        args = (qf, kf, vf, dof, o, g, state, ctx.p, ctx.z, ctx.chunk)
        grads = _bwd_launch(*args) if ctx.kernel else fastmax_bwd_plain(*args)
        return tuple(x.reshape(b, h, n, d) for x in grads) + (None, None, None, None)


def _z(normalize_term: float, d: int) -> float:
    return float(normalize_term) * math.sqrt(d)


def fastmax_trainable(q, k, v, p: int = 2, normalize_term: float = 8.0,
                      chunk: int = DEFAULT_CHUNK, *, plain: bool = False) -> torch.Tensor:
    """Causal fastmax, differentiable in q, k, v (B, H, N, D): K4 forward and K5
    backward on the card, the plain walks on the CPU or with ``plain=True``.
    The normalizer is z = normalize_term * sqrt(D), as in the reference."""
    return _Fastmax.apply(q, k, v, p, _z(normalize_term, q.shape[-1]), chunk, plain)


def fastmax_forward(q, k, v, p: int = 2, normalize_term: float = 8.0,
                    chunk: int = DEFAULT_CHUNK, *, plain: bool = False) -> torch.Tensor:
    """Causal fastmax forward alone (the reference's ``fastmax_pallas``): K4
    with its g and state outputs switched off."""
    b, h, n, d = q.shape
    qf, kf, vf = (x.reshape(b * h, n, d) for x in (q, k, v))
    z = _z(normalize_term, d)
    if use_kernel(q, k, v, plain=plain):
        o = _fwd_launch(qf, kf, vf, p, z, chunk, train=False)
    else:
        o = fastmax_fwd_plain(qf, kf, vf, p, z, chunk)[0]
    return o.reshape(b, h, n, d)
