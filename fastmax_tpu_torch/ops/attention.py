"""Attention algorithms and the ``attn_alg`` dispatch (counterpart of
``fastmax_tpu/ops/attention.py``).

Softmax attention runs on grouped shapes: q (B, Hq, T, D) is viewed as
(B, G, Hq/G, T, D) against un-expanded k/v (B, G, S, D). The dispatch
``attention`` takes every ``attn_alg`` of the fork for the causal
full-sequence forward: ``quadratic``, and the linear arms of
``ops/fastmax.py`` on KV heads repeated to the query heads first:
``fastmax``/``fastmax_cuda`` (degree 2: the kernel pair K4/K5 at head sizes up
to 64, the reversible float32 scan above), ``linearmax`` (degree 1) and
``performer`` (k and v cut to the query length, as the reference cuts them).
Over a KV cache (``is_decode``) the linear arms run as the reference runs
them there: fastmax and linearmax unmasked over the whole padded cache (the
global-sum formula, whose count term is the query length), performer causal
over the cache's first T positions. That differs from the causal forward on
purpose, as it does in the reference; the serving path takes the running
state instead (``models/gpt.forward_linear_cache``).

Quadratic attention at T >= ``BLOCKWISE_MIN_T`` takes the reference's
trainable route (``fastmax_tpu/ops/attention.py:289-347``) with its constants
and ``FASTMAX_TPU_*`` environment names: the KV heads are repeated, then
``FASTMAX_TPU_TRAIN_ATTN`` picks ``flash2`` (the fused entry, padded to its
block), ``flash`` (the split entry, padded to lcm(128, 128)) or
``blockwise``; flash needs a head size divisible by 64 and flash2 also
``_fused_eligible``, else blockwise takes it. The port routes as the reference
does on its chip, flash2 by default, on every device: on the card the flash
entries launch K6/K7, on the CPU they run their plain versions. ``auto`` (the
reference's timing probe) times blockwise against flash2 at the real shape at
first use and keeps the winner (``_PROBE_CACHE``, ``_build/kernel_probe.json``).
"""

from __future__ import annotations

import functools
import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from .blockwise_attention import blockwise_attention
from .fastmax import fastmax, linearmax, performer
from .flash_attention import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, _fused_block, _fused_eligible,
                              flash_attention_fused, flash_attention_trainable)

NEG_INF = float("-inf")

# full-sequence quadratic forwards at T >= this take the trainable route
BLOCKWISE_MIN_T = int(os.environ.get("FASTMAX_TPU_BLOCKWISE_MIN_T", 1024))
# the blockwise query block; 0 sizes it so one (B, H, block, T) f32 transient stays near 512 MB
BLOCKWISE_BLOCK = int(os.environ.get("FASTMAX_TPU_BLOCKWISE_BLOCK", 0))
# the trainable kernel: "flash2" (fused entry), "flash" (split entry), "blockwise", or
# "auto": the faster of blockwise and flash2 at the real shape, timed at first use
TRAIN_ATTN = os.environ.get("FASTMAX_TPU_TRAIN_ATTN", "flash2")
# "auto" probes only at T >= this; shorter sequences take blockwise
FLASH_MIN_T = int(os.environ.get("FASTMAX_TPU_FLASH_MIN_T", 2048))

_PROBE_CACHE: dict = {}   # probe key -> winner, in this process
PROBE_TIMES: dict = {}    # probe key -> {"blockwise": s, "flash2": s} of the probes run here


def repeat_kv_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """Expand grouped KV heads (B, G, S, D) -> (B, n_head, S, D)."""
    b, g, s, d = x.shape
    if g == n_head:
        return x
    rep = n_head // g
    return x[:, :, None].expand(b, g, rep, s, d).reshape(b, n_head, s, d)


def softmax_f32(scores: torch.Tensor) -> torch.Tensor:
    """Numerically stable float32 softmax along the last axis; fully masked
    rows (all -inf) give zeros rather than NaN."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    denom = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _grouped_mask(mask, b, hq, g, t, s):
    return torch.broadcast_to(mask, (b, hq, t, s)).reshape(b, g, hq // g, t, s)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Softmax attention with a float32 softmax.

    q: (B, Hq, T, D); k, v: (B, G, S, D) with Hq % G == 0. ``mask`` is a
    boolean tensor broadcastable to (B, Hq, T, S); True = attend. With
    ``is_causal`` and no mask a causal mask is applied. Returns (B, Hq, T, D).
    """
    b, hq, t, d = q.shape
    g, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, g, hq // g, t, d)
    scores = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), k.float()) * scale
    if mask is None and is_causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
    if mask is not None:
        scores = torch.where(_grouped_mask(mask, b, hq, g, t, s), scores, NEG_INF)
    probs = softmax_f32(scores)
    out = torch.einsum("bgrts,bgsd->bgrtd", probs.to(v.dtype), v)
    return out.reshape(b, hq, t, d)


def int8_cache_attention(
    q: torch.Tensor,
    k_codes: torch.Tensor,
    v_codes: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention directly over an int8 KV cache, with the
    per-position scales applied to the scores and probabilities:

      scores[..., s] = (q . k_codes[s]) * k_scale[s]
      out = sum_s (probs[..., s] * v_scale[s]) v_codes[s]

    q: (B, Hq, T, D); k_codes/v_codes: (B, G, S, D) int8; scales (B, G, S).
    """
    b, hq, t, d = q.shape
    g, s = k_codes.shape[1], k_codes.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, g, hq // g, t, d)
    scores = torch.einsum("bgrtd,bgsd->bgrts", qg.float(), k_codes.to(q.dtype).float())
    scores = scores * (scale * k_scale.float())[:, :, None, None, :]
    if mask is not None:
        scores = torch.where(_grouped_mask(mask, b, hq, g, t, s), scores, NEG_INF)
    probs = softmax_f32(scores)
    pv = (probs * v_scale.float()[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bgrts,bgsd->bgrtd", pv.float(), v_codes.float()).to(q.dtype)
    return out.reshape(b, hq, t, d)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attn_alg: str,
    head_size: int,
    is_decode: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Dispatch on ``attn_alg`` for the causal full-sequence forward (the
    reference's ``mask=None``). q: (B, Hq, T, D); k, v: (B, G, T, D), or
    (B, G, S, D) over a KV cache with ``is_decode`` (the linear algorithms
    only: fastmax and linearmax then run unmasked). For the linear algorithms
    the grouped KV heads are repeated to the full head count first. It takes
    no explicit mask: a speculative verify (T = k+1 rows over a KV cache)
    goes through the cached forward (``models/gpt.apply_attn``), to the flash
    kernel at a scalar position where the cache is flash-eligible, else to
    the masked ``scaled_dot_product_attention`` over the dense or dequantized
    int8 cache, as the batcher's per-slot verify always does."""
    if attn_alg == "quadratic":
        if q.shape[2] >= BLOCKWISE_MIN_T:
            return _long_causal(q, k, v, head_size, plain)
        return scaled_dot_product_attention(q, k, v, scale=1.0 / head_size ** 0.5,
                                            is_causal=True)
    n_head = q.shape[1]
    k = repeat_kv_heads(k, n_head)
    v = repeat_kv_heads(v, n_head)
    if attn_alg == "performer":
        t = q.shape[2]
        return performer(q, k[:, :, :t], v[:, :, :t])
    if attn_alg == "linearmax":
        return linearmax(q, k, v, p=1, mask=not is_decode)
    if attn_alg in ("fastmax", "fastmax_cuda"):
        return fastmax(q, k, v, p=2, mask=not is_decode, plain=plain)
    raise ValueError(f"Attention algorithm {attn_alg} not supported")


def _auto_block(b: int, h: int, t: int) -> int:
    limit = 512 * 2**20
    blk = limit // max(b * h * t * 4, 1)
    return int(max(128, min(512, (blk // 128) * 128)))


def _probe_path() -> Path:
    """The port's own record of probed winners (never the reference's
    ``.kernel_probe.json``): the two packages do not read each other's."""
    return Path(__file__).resolve().parents[1] / "_build" / "kernel_probe.json"


def _time_fwd_bwd(fn, q, k, v) -> float:
    """Seconds of one forward + backward of ``fn`` with the gradients of all
    of q, k and v (grading q alone would leave out parts of a backward):
    warmed once, the best of two, timed by CUDA events on the card."""
    def run():
        q_, k_, v_ = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = fn(q_, k_, v_)
        torch.autograd.grad(out.float().sum(), (q_, k_, v_))

    run()
    best = float("inf")
    for _ in range(2):
        if q.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def _isolated(fn):
    """Run ``fn()`` on a thread of its own: dispatch modes (a selective
    checkpoint's policy), saved-tensor hooks (a checkpoint's) and the grad
    mode are per thread, so the probe's own forward and backward inside a
    checkpointed block neither feed nor read the block's checkpoint."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            box["err"] = e

    th = threading.Thread(target=target, name="train-kernel-probe")
    th.start()
    th.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def _probe_train_kernel(b: int, h: int, t: int, d: int, device) -> str:
    """The reference's probe (``fastmax_tpu/ops/attention.py:67``): time one
    forward + backward of the blockwise route and of the fused flash entry
    at the real (b, h, t, d) in bf16 and keep the faster. The winner is
    cached in the process and on disk (``_probe_path()``), keyed by the
    device's name ("cpu" off the card) and the shape; the timings of a
    probe run in this process are in ``PROBE_TIMES``. A shape outside
    ``_fused_eligible`` takes blockwise without timing."""
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    key = f"{name}|{b}x{h}x{t}x{d}"
    if key in _PROBE_CACHE:
        return _PROBE_CACHE[key]
    path = _probe_path()
    disk = {}
    if path.exists():
        try:
            disk = json.loads(path.read_text())
        except (OSError, ValueError):
            disk = {}
    if key in disk:
        _PROBE_CACHE[key] = disk[key]
        return disk[key]
    if not _fused_eligible(t, d):
        _PROBE_CACHE[key] = "blockwise"
        return "blockwise"

    def probe():
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device=device, dtype=torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / d ** 0.5
        return {kern: _time_fwd_bwd(lambda q, k, v: _route(kern, q, k, v, scale, False), q, k, v)
                for kern in ("blockwise", "flash2")}

    times = _isolated(probe)
    winner = "flash2" if times["flash2"] < times["blockwise"] else "blockwise"
    PROBE_TIMES[key] = times
    _PROBE_CACHE[key] = disk[key] = winner
    try:
        # atomic publish: each process writes a private temp file and races
        # only on the rename
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".kernel_probe.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(disk, indent=1))
        os.replace(tmp, path)
    except OSError:
        pass
    return winner


# Set by a trainer on a mesh: agree(key, probe) runs ``probe`` on global rank 0 only
# and gives every rank its winner, once a key (ranks sharing a card time differently).
AGREE_TRAIN_KERNEL: list = [None]


def _train_kernel(t: int, head_size: int, b: int, h: int, device) -> str:
    """``TRAIN_ATTN``, or with "auto" the probe's winner where the fused entry
    could run (a head size divisible by 64, T >= FLASH_MIN_T), else blockwise."""
    if TRAIN_ATTN == "auto":
        if head_size % 64 or t < FLASH_MIN_T:
            return "blockwise"
        probe = functools.partial(_probe_train_kernel, b, h, t, head_size, device)
        if AGREE_TRAIN_KERNEL[0] is not None:
            return AGREE_TRAIN_KERNEL[0]((b, h, t, head_size), probe)
        return probe()
    return TRAIN_ATTN


def _route(kern: str, q, kf, vf, scale: float, plain: bool) -> torch.Tensor:
    """One trainable kernel over q, k, v (B, H, T, D), T padded to its block
    and cut back. Padded tail rows, being causal, never reach a real row."""
    b, h, t, _ = q.shape
    if kern == "flash2":
        blk = max(_fused_block(t) if t % 512 == 0 or t <= 512 else 512, 128)
    elif kern == "flash":
        blk = math.lcm(DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    else:
        blk = BLOCKWISE_BLOCK or _auto_block(b, h, t)
    pad = (-t) % blk
    if pad:
        q, kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, kf, vf))
    if kern == "flash2":
        out = flash_attention_fused(q, kf, vf, scale, plain=plain)
    elif kern == "flash":
        out = flash_attention_trainable(q, kf, vf, scale, plain=plain)
    else:
        out = blockwise_attention(q, kf, vf, scale, blk)
    return out[:, :, :t] if pad else out


def _long_causal(q, k, v, head_size: int, plain: bool) -> torch.Tensor:
    """The reference's trainable route for causal quadratic attention at
    T >= BLOCKWISE_MIN_T."""
    b, h, t, _ = q.shape
    kern = _train_kernel(t, head_size, b, h, q.device)
    if kern in ("flash", "flash2") and head_size % 64 == 0:
        if kern == "flash2" and not _fused_eligible(t, head_size):
            kern = "blockwise"
    else:
        kern = "blockwise"
    return _route(kern, q, repeat_kv_heads(k, h), repeat_kv_heads(v, h), 1.0 / head_size ** 0.5,
                  plain)
