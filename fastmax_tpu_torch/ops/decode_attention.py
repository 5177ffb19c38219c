"""Single-token decode attention over the int8 KV cache (counterpart of
``fastmax_tpu/ops/decode_attention.py``).

A CUDA tensor goes to the hand-written kernel ``csrc/int8_decode_attention.cu``
(which replaces both Pallas kernels of the JAX file); a CPU tensor, or
``plain=True``, goes to ``int8_decode_attention_plain``, which repeats the
kernel's arithmetic in PyTorch:

  scores = (q . k_codes) * k_scale * scale, masked to j <= pos[b] with -1e30
  p = f32 softmax;  out = ((p * v_scale) cast to q's dtype) . v_codes

The output is in q's dtype. The stacked entry reads layer ``layer`` of the
(L, B, G, S, D) cache; the kernel takes a pointer into the stack, so no
slice is copied.

The kernel has two routes, chosen by ``decode_splits`` from the shapes alone
(never from pos, so a call stays free of host syncs and can be captured in a
CUDA graph): one block per (b, g) (nsplit = 1), or a split of the cache
positions into chunks of ``split_chunk(S, nsplit)`` that normalises p by the
row's global max and sum before the rounding, as the reference does.
"""

from __future__ import annotations

import functools

import torch

from ..kernels.build import KERNELS, use_kernel

NEG_INF = -1e30
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# kSplitWarps, kRowsPerPass, kTile, kMaxChunk, kMaxSplits and kBarBytes in the .cu
_SPLIT_WARPS, _ROWS_PER_PASS, _TILE, MAX_CHUNK, MAX_SPLITS = 4, 4, 128, 512, 64
_BAR_BYTES = -(-(2 * (2 + MAX_CHUNK // _TILE) * 8) // 16) * 16
# decode_splits' rule: the chunk is the smallest of these that leaves at most
# _SPLIT_ITEMS items (chunks of a (b, g)) at full S and at most MAX_SPLITS chunks
# a (b, g); measured with tools/k2_ab.py (64 at Llama-2-7B batch 1, S = 1024;
# 256 at 8 slots, S = 4096)
SPLIT_CHUNKS = (64, 128, 256, 512)
_SPLIT_ITEMS = 4096


def int8_decode_eligible(t: int, d: int, s: int, r: int = 1) -> bool:
    """The reference's conditions: t == 1, d in {64, 128}, S % 128 == 0 and
    S*d*4 <= 8 MiB, for any R (``r`` is taken for the call sites; the split
    route holds no whole softmax row in shared memory)."""
    return t == 1 and d in (64, 128) and s * d * 4 <= 8 * 2**20 and s % 128 == 0


def one_block_smem(r: int, s: int, d: int) -> int:
    """Shared memory of the one-block kernel in bytes: q rows, score rows,
    partial outputs (8 warps x 4 rows), in f32 words; as smem_bytes in the .cu."""
    return 4 * (r * d + r * s + 32 * d)


def split_chunk(s: int, nsplit: int) -> int:
    """Positions a block of the split route takes: S over nsplit, rounded up
    to 64; as split_chunk in the .cu."""
    per = -(-s // nsplit)
    return -(-per // 64) * 64


def split_smem(r: int, chunk: int, d: int, nsplit: int, elem: int = 2) -> int:
    """Shared memory of the larger split kernel in bytes, for q elements of
    ``elem`` bytes; as split_scores_smem and split_values_smem in the .cu."""
    sst = -(-nsplit // 2) * 2
    scores_slot = 4 * chunk + -(-(r * d * elem) // 16) * 16 + chunk * d
    values_slot = 4 * chunk * (1 + r) + 8 * r * sst + chunk * d
    rows_per_pass = 1 if r == 1 else _ROWS_PER_PASS
    scores = _BAR_BYTES + 2 * scores_slot + 4 * (r * chunk + (r * d if r > 1 else 0)
                                                 + _SPLIT_WARPS)
    values = _BAR_BYTES + 2 * values_slot + 4 * (2 * r + _SPLIT_WARPS * rows_per_pass * d)
    return max(scores, values)


@functools.lru_cache(maxsize=256)
def decode_splits(bg: int, s: int, r: int, d: int) -> int:
    """The route of a call with B*G = ``bg`` (b, g) pairs over an S-position
    cache, R query rows a group and head size d, read from the shapes only: the
    number of chunks of the split route, at the chunk of the rule above halved
    while its shared memory does not fit (the split was faster than the
    one-block kernel at every shape tools/k2_ab.py timed); 1, the one-block
    kernel, only where the split cannot take the shape and it can."""
    chunk = next((c for c in SPLIT_CHUNKS
                  if bg * -(-s // c) <= _SPLIT_ITEMS and -(-s // c) <= MAX_SPLITS),
                 SPLIT_CHUNKS[-1])
    while chunk > SPLIT_CHUNKS[0] and split_smem(r, chunk, d, -(-s // chunk), 4) > _SMEM_LIMIT:
        chunk //= 2
    nsplit = -(-s // chunk)
    if ((nsplit > MAX_SPLITS or split_smem(r, chunk, d, nsplit, 4) > _SMEM_LIMIT)
            and one_block_smem(r, s, d) <= _SMEM_LIMIT):
        return 1
    return nsplit


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return torch.broadcast_to(pos.to(device=device, dtype=torch.int32).reshape(-1), (b,))
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def int8_decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale, pos, *, scale: float):
    """q: (B, Hq, 1, D); k_codes/v_codes: (B, G, S, D) int8; k_scale/v_scale:
    (B, G, S); pos: (B,) or scalar. Returns (B, Hq, 1, D) in q's dtype."""
    b, hq, t, d = q.shape
    g, s = k_codes.shape[1], k_codes.shape[2]
    assert t == 1, t
    posv = _pos_vector(pos, b, q.device)
    qg = q.reshape(b, g, hq // g, d)
    sc = torch.einsum("bgrd,bgsd->bgrs", qg.float(), k_codes.to(q.dtype).float())
    sc = sc * (scale * k_scale.float())[:, :, None, :]
    mask = torch.arange(s, device=q.device)[None, :] <= posv[:, None]
    sc = torch.where(mask[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    pv = (p * v_scale.float()[:, :, None, :]).to(q.dtype)
    out = torch.einsum("bgrs,bgsd->bgrd", pv.float(), v_codes.to(q.dtype).float())
    return out.to(q.dtype).reshape(b, hq, 1, d)


def _launch(q, kc_all, vc_all, ks_all, vs_all, layer: int, pos, scale: float,
            split: int | None = None):
    """kc_all/vc_all: (L, B, G, S, D) int8; ks_all/vs_all: (L, B, G, S) f32.
    ``split`` overrides ``decode_splits``' route (1: the one-block kernel; k > 1:
    k chunks), for timing."""
    b, hq, t, d = q.shape
    _, bb, g, s, dd = kc_all.shape
    if t != 1 or bb != b or dd != d or hq % g:
        raise ValueError(f"shapes q {tuple(q.shape)} cache {tuple(kc_all.shape)}")
    r = hq // g
    if not int8_decode_eligible(t, d, s, r):
        raise ValueError(f"int8 decode kernel does not take d={d} S={s}")
    nsplit = decode_splits(b * g, s, r, d) if split is None else int(split)
    if nsplit < 1:
        raise ValueError(f"int8 decode kernel: nsplit={nsplit}")
    chunk = s if nsplit == 1 else split_chunk(s, nsplit)
    if nsplit > 1:
        nsplit = -(-s // chunk)  # the chunks that hold positions
    smem = (one_block_smem(r, s, d) if nsplit == 1
            else split_smem(r, chunk, d, nsplit, q.element_size()))
    if smem > _SMEM_LIMIT or (nsplit > 1 and (chunk > MAX_CHUNK or nsplit > MAX_SPLITS)):
        raise ValueError(f"int8 decode kernel: nsplit={nsplit} (chunk {chunk}) at R={r} S={s} "
                         f"d={d} needs {smem} bytes of shared memory (limit {_SMEM_LIMIT}; "
                         f"chunks of at most {MAX_CHUNK}, at most {MAX_SPLITS} of them)")
    for name, a, dt in (("k", kc_all, torch.int8), ("v", vc_all, torch.int8),
                        ("k_scale", ks_all, torch.float32),
                        ("v_scale", vs_all, torch.float32)):
        if a.dtype != dt or not a.is_contiguous() or a.device != q.device or a.data_ptr() % 16:
            raise ValueError(f"{name}: need a contiguous, 16-byte aligned {dt} tensor on "
                             f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or bfloat16")
    q = q.contiguous()
    if q.data_ptr() % 16:  # the split's bulk copies read q's rows from 16-byte aligned addresses
        q = q.clone()
    posv = _pos_vector(pos, b, q.device).contiguous()
    out = torch.empty_like(q)
    scratch = [0, 0, 0]
    if nsplit > 1:
        # one f32 buffer: scores (B, Hq, S), stats (B*Hq, nsplit rounded up to even, 2),
        # partials (B*Hq, nsplit, D)
        sizes = (b * hq * s, b * hq * -(-nsplit // 2) * 4, b * hq * nsplit * d)
        work = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
        offset = work.data_ptr()
        for i, n in enumerate(sizes):
            scratch[i] = offset
            offset += 4 * n

    def at(a):
        return a.data_ptr() + layer * a.stride(0) * a.element_size()

    KERNELS["int8_decode_attention"].launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), at(kc_all), at(vc_all), at(ks_all),
        at(vs_all), posv.data_ptr(), out.data_ptr(), *scratch, b, hq, g, s, d, float(scale),
        nsplit)
    return out


def int8_decode_attention(q, k_codes, v_codes, k_scale, v_scale, pos, *, scale: float,
                          plain: bool = False, split: int | None = None):
    """Per-layer cache: k_codes/v_codes (B, G, S, D). Returns (B, Hq, 1, D).
    ``split``: the kernel's route, as ``_launch`` takes it."""
    if not use_kernel(q, k_codes, plain=plain):
        return int8_decode_attention_plain(q, k_codes, v_codes, k_scale, v_scale, pos,
                                           scale=scale)
    return _launch(q, k_codes[None], v_codes[None], k_scale[None], v_scale[None], 0, pos,
                   scale, split)


def int8_decode_attention_stacked(q, k_all, v_all, ks_all, vs_all, layer: int, pos, *,
                                  scale: float, plain: bool = False, split: int | None = None):
    """Layer ``layer`` of the stacked cache: k_all/v_all (L, B, G, S, D) int8,
    ks_all/vs_all (L, B, G, S) f32; pos (B,) or scalar. Returns (B, Hq, 1, D).
    ``split``: the kernel's route, as ``_launch`` takes it."""
    layer = int(layer)
    if not use_kernel(q, k_all, plain=plain):
        return int8_decode_attention_plain(q, k_all[layer], v_all[layer], ks_all[layer],
                                           vs_all[layer], pos, scale=scale)
    return _launch(q, k_all, v_all, ks_all, vs_all, layer, pos, scale, split)
