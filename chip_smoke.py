#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastmax_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. header: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel of the port, from ``fastmax_tpu_torch/csrc``;
3. the int4 rank-1 matmul kernel against its plain PyTorch version at the four
   Llama-2-7B linear shapes, m in {1, 8, 64, 512}, stacked (layer 2 of 3) and
   per-layer, f32 and bf16 x, with per-launch times at m in {1, 8, 64};
4. the int8 decode-attention kernel against its plain version (7B: B=1, G=32,
   D=128, S=1024, pos in {0, 63, 1023}; a GQA case and a D=64 case);
5. the batch-1 path: a random Llama-2-7B (full width, all 32 layers) in the
   rank-1 int4 format, int8 KV cache, block_size 1024, a 64-token prompt,
   ``InferenceEngine.generate`` of 256 tokens greedy; launch counts of K1 and
   K2 during that call (each must be > 0); TTFT, decode tok/s and peak
   memory; first-token and first-decode-step logits with the kernels against
   the same forward through the plain versions;
6. the flash prefill kernel against its plain version at the 7B shapes
   (B=1, Hq=G=32, D=128, S=4096, bf16: 512-row chunks at pos0 0, 1536 and
   3584, a whole 2048-token prompt, a 1024-token suffix at pos0 2048, and a
   wave of 8 1024-token prompts; a GQA case with ragged T; head sizes 192 and
   256; an f32 case), with device times (k/v cold), bounds and one
   ``scaled_dot_product_attention`` call as yardstick;
7. the serving path: the same 7B at its full 4096-token context behind a
   ``ContinuousBatcher`` (8 slots, int8 cache, decode quantum 8, adaptive)
   and the HTTP ``Server``: 8 requests from 4 client threads (prompts of
   256-3072 tokens, 64 new tokens; six greedy, two sampled, one streamed),
   then ``run_load`` closed loop over 16 requests, over 16 requests that
   share a 2048-token prefix registered in the prefix cache, and over 8
   requests of one 128-token bucket, admitted as one batched wave; launch counts of
   K1, K2 and K3 over the whole phase (each must be > 0); tok/s, TTFT
   percentiles, peak memory; profiles of one prefill and one decode step;
   the batcher's greedy tokens against ``InferenceEngine.generate`` (a
   divergence fails unless the top-2 margin there is a near-tie) and its
   first-token logits against the engine's; and 32-layer prefill logits at
   S=4096 with the kernels against the plain route, through the engine's
   512-token chunks and through the batcher's whole-prompt and prefix-suffix
   prefills;
8. training: the fastmax kernels K4 (forward, with and without its g and
   state outputs) and K5 (the reverse walk), through ``fastmax_trainable``
   and ``fastmax_forward``, against their plain versions at the shape a
   training step gives them (B=4, H=8, N=512, D=64, p=2, f32 and bf16; p=1;
   N=2048 at D=16; a ragged N=200 through ``fastmax()``), on inputs where
   s = q.k / z is of order 1 so that the degree-2 terms weigh as much as the
   others; those terms alone (p=2 minus p=1) kernels against plain; K4 and
   K5 repeating bit for bit; device times (inputs cold) and bounds;
   ``pretrain.setup`` on
   easy-transformer-fastmax with its defaults (float32, global batch 8,
   micro-batch 4, T=512, remat, AdamW) for 40 steps over a ``train.bin``
   made from the repository's own ``*.md`` and ``*.py`` bytes: tokens/s, step
   time, MFU against the card's f32 peak, peak memory, the first and last
   logged loss (the last must be lower), K4/K5 launch counts (exactly 2 and 1
   per layer per micro-batch under remat), a profile of one step; one step's
   loss and every gradient with the kernels against ``plain=True`` (qkv
   weights scaled so that s is of order 1); and the
   same 40 steps of easy-transformer (quadratic attention) as a yardstick;
9. finetuning: the trainable flash kernels K6 (forward: out and lse) and K7
   (backward: dq, dk, dv), through ``flash_attention_fused``,
   ``flash_attention_trainable`` and ``attention()`` (T=1088, padded to 1536),
   against ``plain=True`` at the finetune shape (B=2, H=32, T=2048, D=128,
   bf16 and f32), at D=64, 192 and 256, on inputs whose scores have a
   standard deviation of about 3, with a float64 yardstick; K6/K7 repeating
   bit for bit; device times in a CUDA graph (inputs cold), bounds, the plain
   versions and ``scaled_dot_product_attention`` (forward; forward and
   backward); then ``finetune.setup`` itself: QLoRA (LoRA r 8, alpha 16 on
   query and value) on an NF4 Llama-2-7B at full width, bf16, T up to 2048,
   global batch 8, micro-batch 2, remat, over SFT examples of 1100-2600
   tokens made from the repository's own text: step time, tokens/s, peak
   memory, the loss, lora_B moved off zero, K6/K7 launches (exactly 2 and 1
   per layer per micro-batch), the written lora_weights.safetensors read
   back, a profile of one step; and one step of the same model cut to 4
   layers, kernels against plain (bf16 and f32), loss and every LoRA
   gradient.

It prints the kernels' JSON line, the card line and, last, the device JSON
line. Details go to ``chiprun_out/chip_smoke.json``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory rate, f32 rate outside the
# tensor cores, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12

# tolerances, stated before the run
INT4_ATOL, INT4_RTOL = 2e-4, 2e-3          # f32 x: the reference's own (test_quant_pallas.py)
INT4_BF16_RTOL = 2.0 ** -7                 # bf16 x: one bf16 ulp of the rounded output
ATTN_MAX_ABS = 2e-2                        # the reference's own (test_decode_attention.py)
LOGITS_REL_TOL = 2e-2                      # full 7B forward, kernels vs plain, bf16 activations
FLASH_BF16_ATOL = 1e-2                     # a bf16 ulp (2^-7) of outputs up to 2, and a p rounding
FLASH_F32_ATOL, FLASH_F32_RTOL = 2e-5, 1e-4  # the reference's own (test_flash_attention.py)
NEAR_TIE_REL = LOGITS_REL_TOL              # top-2 margin under this x max|logit|: a near-tie
N_SLOTS = 8
# fastmax K4/K5 against their plain walks. q and k are drawn with the standard
# deviation below, so that s = q.k / z (z = 8 sqrt(D)) has one of about 1 at
# p = 2 and the degree-2 terms s^2 / 2 weigh as much as the others (at std 0.5
# they would move the outputs by about 1e-5 of their size); p = 1 at std 1,
# where its normaliser, a sum of 1 + s, stays away from 0. v and the output
# cotangent have std 1. Each output is held by max|kernel - plain| / max|plain|:
# float32 1e-5 forward and 1e-4 gradients (dq sums terms far larger than
# itself, which cancel: on an H100 two f32 walks differ there by 1e-5 to 3e-5
# of the largest dq, and each lies as far from a float64 O(N^2) reference,
# which the checks report); bfloat16 the reference's (test_fastmax_pallas.py)
# 4e-2 forward and 6e-2 gradients. A walk of 16 chunks or more rewinds its
# state by subtracting 16 or more updates from the final one, and its f32 dq
# then lies up to 1.5e-4 of the largest from float64 by either route: its
# gradients are held at 1e-3. The
# degree-2 terms alone, o, dq, dk and dv at p = 2 minus p = 1 on the same
# inputs (q, k std 1), are held at 1e-3 of the plain difference's largest value.
FASTMAX_QK_STD = {2: 8.0 ** 0.5, 1: 1.0}
FASTMAX_F32_REL = {"fwd": 1e-5, "grad": 1e-4, "grad, 16 chunks": 1e-3}
FASTMAX_BF16_REL = {"fwd": 4e-2, "grad": 6e-2}
FASTMAX_PAIR_REL = 1e-3
# one training step, kernels against plain=True, f32, with the qkv weights
# scaled so that s has a standard deviation of about 1 (at the init std 0.02
# it is 0.025): the loss (relative) and each gradient leaf (of its largest entry)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-6, 1e-4
TRAIN_STEPS = 40

LLAMA7B_LINEARS = [("qkv", 4096, 12288), ("attn_proj", 4096, 4096),
                   ("fc_12", 4096, 22016), ("mlp_proj", 11008, 4096)]


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` eager calls, by CUDA events. Where the
    host issues work more slowly than the card runs it, this is host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, reps: int = 3) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed ``reps`` times, timed by CUDA events (no host time inside)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def bound(nbytes: int, flops: int, bf16: bool) -> dict:
    """Least time of a call: its bytes (each input read once, each output
    written once) over the memory rate, against its operations over the
    peak rate for its inputs' type (bf16: the tensor cores; f32: the f32
    units). ``bound_f32_ms`` takes the operations at the f32 rate, the rate
    the present kernels compute at."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / (BF16_TC_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S) * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_f32_ms": max(b_ms, flops / F32_FLOPS_PER_S * 1e3)}


# ----------------------------------------------------------------- phase 3
def check_int4(torch, gen, results):
    from fastmax_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    worst = 0.0
    rows = []
    for name, k, n in LLAMA7B_LINEARS:
        k_pad, n_pad = k + (-k) % 512, n + (-n) % 1024
        pw = torch.randint(-2**31 + 1, 2**31 - 1, (3, 1, n_pad // 1024, k_pad, 128),
                           generator=gen, device=dev, dtype=torch.int32)
        u = torch.rand((3, k), generator=gen, device=dev) * 0.03 + 0.005
        v = torch.rand((3, n), generator=gen, device=dev) + 0.5
        p = {"q4r1": pw, "u4": u, "v4": v}
        p2 = {"q4r1": pw[2], "u4": u[2], "v4": v[2]}
        for m in (1, N_SLOTS, 64, 512):
            x = torch.randn((m, k), generator=gen, device=dev)
            ref = qk.int4_matmul_rank1_plain(x, pw[2], u[2], v[2])
            checks = [("stacked", qk.int4_matmul_rank1_stacked(x, p, 2))]
            if m <= qk._INT4_MAX_M:
                checks.append(("per-layer", qk.int4_matmul_rank1(x, p2)))
            for entry, got in checks:
                err = (got - ref).abs()
                bad = err > INT4_ATOL + INT4_RTOL * ref.abs()
                worst = max(worst, float(err.max()))
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"int4 {name} m={m} {entry}: max err "
                                         f"{float(err.max()):.3e}")
            xb = x.to(torch.bfloat16)
            refb = qk.int4_matmul_rank1_plain(xb, pw[2], u[2], v[2])
            gotb = qk.int4_matmul_rank1_stacked(xb, p, 2).float()
            errb = (gotb - refb).abs()
            if bool((errb > INT4_ATOL + INT4_BF16_RTOL * refb.abs()).any()):
                raise AssertionError(f"int4 {name} m={m} bf16: max err {float(errb.max()):.3e}")
            torch.cuda.synchronize()
            log(f"  int4 {name:9s} k={k:5d} n={n:5d} m={m:3d}: ok, max abs err "
                f"f32 {float((checks[0][1] - ref).abs().max()):.3e} bf16 {float(errb.max()):.3e}")
        del pw, u, v, p, p2
        # timing at the main path's shapes, weights cold: rotate over enough
        # layers to exceed the 50 MB L2
        layer_bytes = k_pad * n_pad // 2
        n_layers = max(2, math.ceil(160e6 / layer_bytes))
        pw = torch.randint(-2**31 + 1, 2**31 - 1, (n_layers, 1, n_pad // 1024, k_pad, 128),
                           generator=gen, device=dev, dtype=torch.int32)
        u = torch.full((n_layers, k), 0.02, device=dev)
        v = torch.ones((n_layers, n), device=dev)
        p = {"q4r1": pw, "u4": u, "v4": v}
        for m in (1, N_SLOTS, 64):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            it = iter(range(10**9))
            kern_ms = graph_ms(lambda: qk.int4_matmul_rank1_stacked(
                x, p, next(it) % n_layers), calls=2 * n_layers)
            call_ms = time_ms(lambda: qk.int4_matmul_rank1_stacked(
                x, p, next(it) % n_layers), iters=2 * n_layers)
            plain_ms = graph_ms(lambda: qk.int4_matmul_rank1_stacked(
                x, p, next(it) % n_layers, plain=True), calls=n_layers, reps=1)
            nbytes = k * n_pad // 2 + m * k * 2 + k * 4 + n * 4 + m * n * 2
            rows.append({"shape": name, "k": k, "n": n, "m": m, "x_dtype": "bf16",
                         "ms": kern_ms, "call_ms": call_ms, "plain_ms": plain_ms,
                         **bound(nbytes, 2 * m * k * n, bf16=True)})
            log(f"  int4 {name:9s} m={m:3d} bf16: kernel {kern_ms * 1e3:8.1f} us (eager call "
                f"{call_ms * 1e3:7.1f} us)  plain {plain_ms * 1e3:8.1f} us  bound "
                f"{rows[-1]['bound_ms'] * 1e3:6.1f} us ({rows[-1]['bound_by']}; "
                f"{rows[-1]['bound_f32_ms'] * 1e3:6.1f} us at the f32 rate)")
        del pw, u, v, p
    # several k tiles (gk = 8, tk = 512): the general word addressing
    k, n = 4096, 4096
    pw = torch.randint(-2**31 + 1, 2**31 - 1, (3, k // 512, n // 1024, 512, 128),
                       generator=gen, device=dev, dtype=torch.int32)
    u = torch.rand((3, k), generator=gen, device=dev) * 0.03 + 0.005
    v = torch.rand((3, n), generator=gen, device=dev) + 0.5
    for m in (1, 64):
        x = torch.randn((m, k), generator=gen, device=dev)
        ref = qk.int4_matmul_rank1_plain(x, pw[2], u[2], v[2])
        err = (qk.int4_matmul_rank1_stacked(x, {"q4r1": pw, "u4": u, "v4": v}, 2) - ref).abs()
        worst = max(worst, float(err.max()))
        if bool((err > INT4_ATOL + INT4_RTOL * ref.abs()).any()):
            raise AssertionError(f"int4 gk=8 m={m}: max err {float(err.max()):.3e}")
        log(f"  int4 gk=8 tk=512 k= {k} n= {n} m={m:3d}: ok, max abs err f32 "
            f"{float(err.max()):.3e}")
    del pw, u, v
    results["int4_times"] = rows
    results["int4_max_abs_err"] = worst
    return worst, rows


# ----------------------------------------------------------------- phase 4
def check_attention(torch, gen, results):
    from fastmax_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")

    def inputs(n_layers, b, g, s, d):
        kc = torch.randint(-127, 128, (n_layers, b, g, s, d), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, (n_layers, b, g, s, d), generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand((n_layers, b, g, s), generator=gen, device=dev) * 0.019 + 0.001
        vs = torch.rand((n_layers, b, g, s), generator=gen, device=dev) * 0.019 + 0.001
        return kc, vc, ks, vs

    worst = 0.0
    cases = [(1, 32, 32, 1024, 128, torch.bfloat16, (0, 63, 1023)),
             (2, 8, 2, 1024, 128, torch.bfloat16, (5, 700)),
             (1, 32, 32, 512, 64, torch.bfloat16, (0, 200, 511)),
             (1, 32, 32, 1024, 128, torch.float32, (63, 1023))]
    for b, hq, g, s, d, qdt, positions in cases:
        kc, vc, ks, vs = inputs(3, b, g, s, d)
        q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(qdt)
        for pos in positions:
            posv = torch.full((b,), pos, dtype=torch.int32, device=dev)
            if b > 1:
                posv[1:] = max(0, pos - 3)
            ref = da.int8_decode_attention_plain(q, kc[2], vc[2], ks[2], vs[2], posv,
                                                 scale=d ** -0.5)
            for entry, got in (
                ("stacked", da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 2, posv,
                                                             scale=d ** -0.5)),
                ("per-layer", da.int8_decode_attention(q, kc[2], vc[2], ks[2], vs[2], posv,
                                                       scale=d ** -0.5))):
                err = float((got.float() - ref.float()).abs().max())
                worst = max(worst, err)
                if not err <= ATTN_MAX_ABS or got.dtype != qdt:
                    raise AssertionError(f"attention b={b} hq={hq} g={g} s={s} d={d} "
                                         f"pos={pos} {entry}: max err {err:.3e}")
            torch.cuda.synchronize()
            log(f"  attn B={b} Hq={hq:2d} G={g:2d} S={s:4d} D={d:3d} {str(qdt)[6:]:8s} "
                f"pos={pos:4d}: ok, max abs err {err:.3e}")
    # timing at 7B shapes, cache cold: rotate over 16 layers (~134 MB)
    rows = []
    n_layers = 16
    kc, vc, ks, vs = inputs(n_layers, 1, 32, 1024, 128)
    q = torch.randn((1, 32, 1, 128), generator=gen, device=dev).to(torch.bfloat16)
    for pos in (191, 1023):
        posv = torch.full((1,), pos, dtype=torch.int32, device=dev)
        it = iter(range(10**9))
        kern_ms = graph_ms(lambda: da.int8_decode_attention_stacked(
            q, kc, vc, ks, vs, next(it) % n_layers, posv, scale=128 ** -0.5), calls=2 * n_layers)
        call_ms = time_ms(lambda: da.int8_decode_attention_stacked(
            q, kc, vc, ks, vs, next(it) % n_layers, posv, scale=128 ** -0.5), iters=2 * n_layers)
        plain_ms = graph_ms(lambda: da.int8_decode_attention_stacked(
            q, kc, vc, ks, vs, next(it) % n_layers, posv, scale=128 ** -0.5, plain=True),
            calls=n_layers, reps=1)
        nbytes = 32 * (pos + 1) * (2 * 128 + 2 * 4) + 2 * 32 * 128 * 2 + 4
        rows.append({"pos": pos, "ms": kern_ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     **bound(nbytes, 4 * 32 * (pos + 1) * 128, bf16=True)})
        log(f"  attn 7B S=1024 pos={pos:4d}: kernel {kern_ms * 1e3:7.2f} us (eager call "
            f"{call_ms * 1e3:6.1f} us)  plain {plain_ms * 1e3:7.1f} us  bound "
            f"{rows[-1]['bound_ms'] * 1e3:5.2f} us ({rows[-1]['bound_by']})")
    results["attn_times"] = rows
    results["attn_max_abs_err"] = worst
    return worst, rows


# ----------------------------------------------------------------- phase 5
KERNEL_GROUPS = (("K1 int4_rank1_matmul", ("int4_gemv_kernel", "int4_gemm_kernel",
                                             "int4_splitk_reduce_kernel")),
                 ("K2 int8_decode_attention", ("int8_decode_attention_kernel",)),
                 ("K3 flash_attention", ("flash_attention_kernel",)),
                 ("K4 fastmax_fwd", ("fastmax_fwd_kernel",)),
                 ("K5 fastmax_bwd", ("fastmax_bwd_kernel",)),
                 ("K6 flash_train_fwd", ("flash_train_fwd_kernel",)),
                 ("K7 flash_train_bwd", ("flash_train_bwd_kernel",)),
                 ("gemm (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma")))


def profile_device(torch, fn, label, per: int = 1) -> dict:
    """Device time of ``fn`` by kernel group (torch.profiler), per ``per``
    (steps or tokens), with the top kernels and the aten calls issued."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    top = []
    averages = prof.key_averages()
    for ev in averages:
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in ev.key.lower() for k in keys)), "other")
        groups[group] += dev_us / per
        top.append((dev_us / per, ev.key[:90], ev.count / per))
    total = sum(groups.values())
    if total <= 0:
        log(f"  profile of {label}: the profiler recorded no device time (not measured)")
        return {"device_us": None}
    aten = sum(ev.count for ev in averages if ev.key.startswith("aten::")) / per
    by_group = ", ".join(f"{k} {v:.1f}" for k, v in groups.items())
    log(f"  profile of {label}: device {total:.1f} us ({by_group}); aten calls (nested ones "
        f"included) {aten:.0f}")
    top = sorted(top, reverse=True)[:8]
    for dev_us, name, count in top:
        log(f"    {dev_us:10.1f} us  x{count:7.1f}  {name}")
    return {"device_us": total, "by_group_us": groups, "aten_calls": aten,
            "top": [{"us": d, "name": n, "calls": c} for d, n, c in top]}


def profile_decode(torch, engine, first, tok_s, steps: int = 8) -> dict:
    """Device time per token of ``steps`` decode steps, and the device's busy
    share at the unprofiled decode rate ``tok_s``."""
    cache = engine.new_cache()
    _, cache = engine.prefill(torch.zeros((1, 64), dtype=torch.int32, device="cuda"), cache)
    prof = profile_device(torch, lambda: engine.decode(cache, first, 64, steps + 1),
                          f"{steps} decode steps, per token", per=steps)
    if prof["device_us"]:
        prof["busy_share"] = prof["device_us"] * 1e-6 * tok_s
        log(f"  device busy share at {tok_s:.2f} tok/s: {prof['busy_share']:.4f}")
    return prof


def main_path(torch, results, card):
    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4
    from fastmax_tpu_torch.ops.sampling import sample

    cfg = Config.from_name("Llama-2-7b-hf")
    cfg.block_size = 1024
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_fake_7b_int4(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"  model build (on device): {time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_seq_length=1024, batch_size=1,
                             weights_mode="quantized", cache_dtype=torch.int8)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(1, 32000, 64), dtype=torch.int32)
    n_new = 256

    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompt, 64 + n_new, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = build.launch_counts()
    log(f"  generate(64 + {n_new}): {gen_s:.3f} s, launches {counts}")
    if tuple(out.shape) != (1, 64 + n_new):
        raise AssertionError(f"generate returned shape {tuple(out.shape)}")
    if counts["int4_rank1_matmul"] <= 0 or counts["int8_decode_attention"] <= 0:
        raise AssertionError(f"a kernel of the batch-1 path was never launched: {counts}")
    first16 = out[0, 64:80].tolist()
    log(f"  first 16 generated tokens: {first16}")

    # TTFT: prefill of the 64-token prompt + first token, warm, best of 3
    ttft = []
    for _ in range(3):
        cache = engine.new_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompt[None].cuda(), cache)
        first = sample(logits)
        first.cpu()
        ttft.append((time.perf_counter() - t0) * 1e3)
    # decode rate: 256 tokens after that prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, _ = engine.decode(cache, first, 64, n_new)
    gen.cpu()
    dec_s = time.perf_counter() - t0
    tok_s = (gen.shape[1] - 1) / dec_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  TTFT (64-token prompt, warm, best of 3): {min(ttft):.2f} ms   [{card}]")
    log(f"  decode: {gen.shape[1] - 1} tokens in {dec_s:.3f} s = {tok_s:.2f} tok/s   [{card}]")
    log(f"  peak device memory: {peak_gb:.3f} GB   [{card}]")
    profile = profile_decode(torch, engine, first, tok_s)

    # kernels vs plain versions through the full 32-layer forward
    cmp = {}
    for plain in (False, True):
        cache = engine.new_cache()
        logits, cache = engine.prefill(prompt[None].cuda(), cache, plain=plain)
        tok = sample(logits)
        with torch.inference_mode():
            step, _ = engine._forward(tok[:, None], cache, 64, plain=plain)
        cmp[plain] = (logits.float(), step[:, -1].float(), tok)
    rel = {}
    for i, name in ((0, "prefill"), (1, "decode_step")):
        a, b = cmp[False][i], cmp[True][i]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"non-finite {name} logits")
        rel[name] = float((a - b).abs().max() / b.abs().max())
    log(f"  logits kernels vs plain, max|diff|/max|plain|: prefill {rel['prefill']:.3e}, "
        f"decode step {rel['decode_step']:.3e} (tolerance {LOGITS_REL_TOL})")
    if max(rel.values()) > LOGITS_REL_TOL:
        raise AssertionError(f"logits differ beyond {LOGITS_REL_TOL}: {rel}")
    results["main_path"] = {
        "model": "Llama-2-7b-hf (random weights, seed 0), q4r1 int4, int8 KV cache",
        "prompt_tokens": 64, "new_tokens": n_new, "generate_s": gen_s,
        "ttft_ms": min(ttft), "ttft_ms_all": ttft, "decode_tok_s": tok_s,
        "peak_gb": peak_gb, "launches": counts, "first16": first16, "profile": profile,
        "logits_rel_diff": rel, "logits_rel_tol": LOGITS_REL_TOL,
        "first_token_kernels_vs_plain": [int(cmp[False][2][0]), int(cmp[True][2][0])],
        "card": card}
    return counts


# ----------------------------------------------------------------- phase 6
def flash_bound(b, hq, g, t, d, pos0, kv_len, bf16: bool) -> dict:
    """Least time for one call: bytes (q, the k/v rows below kv_len, out,
    each once) against the operations (4*D flops per visible (row, key)
    pair)."""
    visible = sum(min(pos0 + i + 1, kv_len) for i in range(t))
    nbytes = (2 if bf16 else 4) * (2 * b * hq * t * d + 2 * b * g * kv_len * d)
    return bound(nbytes, 4 * b * hq * d * visible, bf16)


def sdpa_backend(torch, q, k, v, mask, scale, is_causal: bool = False) -> str:
    """Name of the backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    names = {int(val): name for name, val in SDPBackend.__members__.items()}
    try:  # a private function: the name is a label, not a result, so a miss is reported
        choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, is_causal, scale=scale)
    except (AttributeError, RuntimeError, TypeError) as e:
        return f"not determined ({type(e).__name__})"
    return names.get(int(choice), str(choice))


def check_flash(torch, gen, results):
    from fastmax_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    worst = {bf16: 0.0, f32: 0.0}
    # (B, Hq, G, S, D, dtype, T, pos0s): the 7B shapes serving launches K3 at
    # (512-row chunks, a whole bucketed prompt, a suffix after a cached
    # 2048-token prefix, a batched wave of 8), GQA with ragged T, the head
    # sizes 192 and 256, and f32
    cases = [(1, 32, 32, 4096, 128, bf16, 512, (0, 1536, 3584)),
             (1, 32, 32, 4096, 128, bf16, 2048, (0,)),
             (1, 32, 32, 4096, 128, bf16, 1024, (2048,)),
             (8, 32, 32, 4096, 128, bf16, 1024, (0,)),
             (2, 8, 2, 4096, 64, bf16, 300, (0, 1000)),
             (1, 8, 4, 4096, 192, bf16, 256, (0, 2048)),
             (1, 8, 8, 4096, 256, bf16, 130, (100,)),
             (1, 32, 32, 4096, 128, f32, 512, (0, 3584))]
    for b, hq, g, s, d, dt, t, positions in cases:
        q = torch.randn((b, hq, t, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, g, s, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, g, s, d), generator=gen, device=dev).to(dt)
        for pos0 in positions:
            got = fa.flash_attention(q, k, v, pos0=pos0, kv_len=pos0 + t)
            ref = fa.flash_attention_plain(q, k, v, pos0=pos0, kv_len=pos0 + t)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            if dt == bf16:
                bad = bool((err > FLASH_BF16_ATOL).any())
            else:
                bad = bool((err > FLASH_F32_ATOL + FLASH_F32_RTOL * ref.float().abs()).any())
            worst[dt] = max(worst[dt], float(err.max()))
            if bad or got.dtype != dt or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash B={b} Hq={hq} G={g} D={d} T={t} pos0={pos0} "
                                     f"{dt}: max err {float(err.max()):.3e}")
            log(f"  flash B={b} Hq={hq:2d} G={g:2d} S={s} D={d:3d} T={t:4d} {str(dt)[6:]:8s} "
                f"pos0={pos0:4d}: ok, max abs err {float(err.max()):.3e}")
            del got, ref, err
        del q, k, v
    # timing at the 7B shapes, k/v cold: rotate over 4 layers' k/v (256 MB)
    rows = []
    n_sets, d = 4, 128
    kv = [(torch.randn((1, 32, 4096, d), generator=gen, device=dev).to(bf16),
           torch.randn((1, 32, 4096, d), generator=gen, device=dev).to(bf16))
          for _ in range(n_sets)]
    for t, pos0 in ((512, 0), (512, 1536), (512, 3584), (2048, 0), (1024, 2048)):
        q = torch.randn((1, 32, t, d), generator=gen, device=dev).to(bf16)
        kv_len = pos0 + t
        it = iter(range(10**9))

        def call(plain=False):
            k, v = kv[next(it) % n_sets]
            return fa.flash_attention(q, k, v, pos0=pos0, kv_len=kv_len, plain=plain)

        kern_ms = graph_ms(call, calls=2 * n_sets)
        plain_ms = graph_ms(lambda: call(plain=True), calls=n_sets, reps=1)
        keys = torch.arange(4096, device=dev)[None, :]
        mask = (keys <= pos0 + torch.arange(t, device=dev)[:, None]) & (keys < kv_len)
        backend = sdpa_backend(torch, q, kv[0][0], kv[0][1], mask, d ** -0.5)

        def library():
            k, v = kv[next(it) % n_sets]
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                    scale=d ** -0.5)

        lib_ms = graph_ms(library, calls=2 * n_sets)
        bnd = flash_bound(1, 32, 32, t, d, pos0, kv_len, bf16=True)
        rows.append({"pos0": pos0, "t": t, "kv_len": kv_len, "ms": kern_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "library_backend": backend,
                     **bnd})
        log(f"  flash 7B T={t:4d} pos0={pos0:4d}: kernel {kern_ms * 1e3:8.1f} us  plain "
            f"{plain_ms * 1e3:8.1f} us  SDPA ({backend}) {lib_ms * 1e3:8.1f} us  bound "
            f"{bnd['bound_ms'] * 1e3:6.1f} us ({bnd['bound_by']}, bf16 tensor-core rate; "
            f"{bnd['bound_f32_ms'] * 1e3:6.1f} us at the f32 rate)")
    results["flash_times"] = rows
    results["flash_max_abs_err"] = {str(k)[6:]: v for k, v in worst.items()}
    return worst[bf16], rows


# ----------------------------------------------------------------- phase 7
class ByteTokenizer:
    """Stand-in tokenizer: UTF-8 bytes as ids 3..258 (Llama's byte-fallback
    ids); other ids decode as ``<id>``."""

    eos_id = None

    def encode(self, text):
        return [c + 3 for c in text.encode()]

    def decode(self, ids):
        out = bytearray()
        for i in (int(i) for i in ids):
            out += bytes([i - 3]) if 3 <= i < 259 else f"<{i}>".encode()
        return out.decode(errors="replace")


def http_requests(server, prompts, n_new):
    """8 requests from 4 client threads, two each: six greedy, two sampled
    (temperature 0.8, top-k 40), request 0 as text and request 1 streamed."""
    import threading
    import urllib.request

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/generate",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=600)

    out = [None] * len(prompts)
    errors = []

    def one(i):
        body = {"prompt": prompts[i], "max_new_tokens": n_new}
        if i in (3, 6):
            body.update(temperature=0.8, top_k=40)
        t0 = time.perf_counter()
        if i == 1:
            body["stream"] = True
            tokens, first = [], None
            with post(body) as conn:
                for raw in conn:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    first = first or time.perf_counter()
                    tokens += json.loads(line[6:])["token_ids"]
            out[i] = {"tokens": tokens, "finish_reason": "length", "stream": True,
                      "ttft_s": first - t0}
        else:
            with post(body) as conn:
                out[i] = json.load(conn)
        out[i]["wall_s"] = time.perf_counter() - t0

    def worker(w):
        try:
            for i in (w, w + 4):
                one(i)
        except Exception as e:  # noqa: BLE001 - reported and failed below
            errors.append(f"client {w}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"HTTP clients failed: {errors or 'timed out'}")
    return out


def first_divergence(torch, engine, prompt, a, b):
    """Index of the first differing token of two greedy runs, and the
    engine's top-2 margin and max |logit| there (None if equal)."""
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    if not diff:
        return None
    i = diff[0]
    seq = torch.as_tensor(list(prompt) + list(a[:i]), dtype=torch.int32, device="cuda")[None]
    logits, _ = engine.prefill(seq, engine.new_cache())
    top2 = torch.topk(logits[0].float(), 2).values
    return i, float(top2[0] - top2[1]), float(logits[0].float().abs().max())


def fresh_row(torch, batcher) -> dict:
    """An empty one-slot cache row, as the batcher prefills into."""
    return {k: torch.zeros_like(v[:, :1]) for k, v in batcher.cache.items()}


def batcher_prefill(torch, gpt, batcher, seq, p0: int, row: dict, plain: bool):
    """The batcher's admission prefill of ``seq`` (1, t) from position p0
    (the rows before it already in ``row``): the suffix padded to its
    128-token bucket, one forward; the logits (1, V) at the last real token."""
    t = seq.shape[1]
    bucket = batcher._bucket(t - p0, batcher.max_seq_length - p0)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=batcher.device)
    tokens[:, :t - p0] = seq[:, p0:]
    logits, _ = gpt.forward(batcher.params, batcher.cfg, tokens, input_pos=p0, kv_cache=row,
                            rope_cache=batcher.rope, plain=plain)
    return logits[:, t - p0 - 1]


SERVING_KERNELS = ("int4_rank1_matmul", "int8_decode_attention", "flash_attention")


def serving_path(torch, results, card):
    import numpy as np

    from fastmax_tpu_torch.inference.bench_serving import run_load
    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.inference.server import Server
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4

    cfg = Config.from_name("Llama-2-7b-hf")
    cfg.block_size = 4096
    n_new = 64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_fake_7b_int4(cfg, seed=0)
    batcher = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_seq_length=4096,
                                weights_mode="quantized", cache_dtype=torch.int8,
                                decode_quantum=8, adaptive_quantum=True, prefix_cache_size=4)
    rng = np.random.default_rng(0)
    lengths = rng.integers(256, 3073, 8)
    prompts = [rng.integers(1, 32000, n).tolist() for n in lengths]
    prompts[0] = "".join(chr(c) for c in rng.integers(32, 127, lengths[0]))  # a text prompt
    load_prompts = [rng.integers(1, 32000, n).astype(np.int32)
                    for n in rng.integers(256, 3073, 16)]
    shared = rng.integers(1, 32000, 2048).astype(np.int32)
    prefix_prompts = [np.concatenate([shared, rng.integers(1, 32000, n).astype(np.int32)])
                      for n in rng.integers(64, 1025, 16)]
    # one 128-token bucket (897-1024 tokens: padded to 1024), so the 8 are
    # admitted as one batched wave into the 8 free slots
    wave_prompts = [rng.integers(1, 32000, n).astype(np.int32)
                    for n in rng.integers(897, 1025, N_SLOTS)]
    check_seq = torch.as_tensor(rng.integers(1, 32000, 4096), device="cuda")[None]
    log(f"  prompt lengths: HTTP {lengths.tolist()}, load {[len(p) for p in load_prompts]}, "
        f"prefix load 2048 + {[len(p) - 2048 for p in prefix_prompts]}, wave "
        f"{[len(p) for p in wave_prompts]}")
    # warm-up (cuBLAS handles, first launches) outside the counted run
    w = batcher.submit(np.arange(1, 300, dtype=np.int32), 9, return_request=True)
    while not w.done:
        batcher.step()
    torch.cuda.synchronize()

    build.reset_launch_counts()
    t0 = time.perf_counter()
    server = Server(batcher, ByteTokenizer(), port=0, model_name=cfg.name).start()
    try:
        answers = http_requests(server, prompts, n_new)
    finally:
        server.stop()
    http_s = time.perf_counter() - t0
    for i, a in enumerate(answers):
        toks = a["tokens"]
        if len(toks) != n_new or not all(0 <= x < cfg.padded_vocab_size for x in toks):
            raise AssertionError(f"HTTP request {i}: {len(toks)} tokens, {toks[:8]}...")
    log(f"  HTTP: 8 requests from 4 clients answered in {http_s:.2f} s; walls "
        f"{[round(a['wall_s'], 2) for a in answers]} s; request 1 streamed, first event after "
        f"{answers[1]['ttft_s'] * 1e3:.1f} ms")
    load = run_load(batcher, load_prompts, n_new)
    log(f"  run_load closed loop, 16 requests: {load}   [{card}]")
    t1 = time.perf_counter()
    batcher.register_prefix(shared)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t1
    hits0 = batcher.prefix_cache_hits
    load_prefix = run_load(batcher, prefix_prompts, n_new)
    hits = batcher.prefix_cache_hits - hits0
    log(f"  run_load closed loop, 16 requests on a shared 2048-token prefix (registered in "
        f"{register_s * 1e3:.1f} ms; {hits} prompt tokens reused): {load_prefix}   [{card}]")
    waves0 = batcher.batched_admissions
    load_wave = run_load(batcher, wave_prompts, n_new)
    waved = batcher.batched_admissions - waves0
    torch.cuda.synchronize()
    counts = build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  run_load closed loop, {N_SLOTS} requests of one 128-token bucket ({waved} admitted "
        f"in batched waves): {load_wave}   [{card}]")
    log(f"  launches over the serving phase: {counts}; requests admitted in batched waves: "
        f"{batcher.batched_admissions}; peak device memory {peak_gb:.3f} GB   [{card}]")
    if any(counts[k] <= 0 for k in SERVING_KERNELS):
        raise AssertionError(f"a kernel of the serving path was never launched: {counts}")
    if hits < 16 * 2048:
        raise AssertionError(f"the prefix cache reused {hits} tokens, not 16 x 2048")
    if waved != N_SLOTS:
        raise AssertionError(f"{waved} of the {N_SLOTS} one-bucket requests were admitted in "
                             "a batched wave")

    # the batcher's greedy tokens against InferenceEngine.generate (batch 1)
    engine = InferenceEngine(cfg, batcher.params, max_seq_length=4096,
                             weights_mode="quantized", cache_dtype=torch.int8)
    checks = []
    for i in (2, 4):
        p = prompts[i]
        want = engine.generate(torch.as_tensor(p), len(p) + n_new)[0, len(p):].tolist()
        div = first_divergence(torch, engine, p, want, answers[i]["tokens"])
        # first-token logits: the batcher's whole-prompt prefill against the
        # engine's 512-token chunks
        with torch.inference_mode():
            seq = torch.as_tensor(p, dtype=torch.int32, device="cuda")[None]
            eng_logits = engine.prefill(seq, engine.new_cache())[0][0].float()
            bat_logits = batcher_prefill(torch, gpt, batcher, seq, 0, fresh_row(torch, batcher),
                                         plain=False)[0].float()
        route_rel = float((bat_logits - eng_logits).abs().max() / eng_logits.abs().max())
        checks.append({"request": i, "prompt_len": len(p), "divergence": div,
                       "first_logits_rel_diff": route_rel})
        log(f"  request {i} ({len(p)} tokens): first-token logits, batcher route vs engine "
            f"route, max|diff|/max|engine|: {route_rel:.3e} (tolerance {LOGITS_REL_TOL})")
        if route_rel > LOGITS_REL_TOL:
            raise AssertionError(f"batcher and engine first-token logits differ: {route_rel}")
        if div is None:
            log(f"  request {i} ({len(p)} tokens): batcher greedy tokens == engine.generate's")
            continue
        step, margin, top = div
        near = margin <= NEAR_TIE_REL * top
        log(f"  request {i} ({len(p)} tokens): first divergence at generated token {step}, "
            f"engine top-2 margin {margin:.4f} of max |logit| {top:.3f}: "
            f"{'a near-tie' if near else 'NOT a near-tie'}")
        if not near:
            raise AssertionError(f"batcher and engine diverge beyond a near-tie: {div}")
    del engine

    # where a prefill and a decode step spend the card's time
    with torch.inference_mode():
        row = fresh_row(torch, batcher)
        prof_prefill = profile_device(torch, lambda: gpt.forward(
            batcher.params, cfg, check_seq[:, :2048], input_pos=0, kv_cache=row,
            rope_cache=batcher.rope), "one 2048-token prefill")
        del row
        toks = torch.ones(N_SLOTS, dtype=torch.int32, device="cuda")
        pos = torch.full((N_SLOTS,), 3000, dtype=torch.int32, device="cuda")
        temps0, topk0 = torch.zeros(N_SLOTS, device="cuda"), torch.full((N_SLOTS,), 32000,
                                                                        device="cuda")
        prof_decode = profile_device(torch, lambda: batcher._decode_step(
            toks, pos, temps0, topk0, False), f"one decode step at {N_SLOTS} slots, positions 3000")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(8):
            batcher._decode_step(toks, pos, temps0, topk0, False)
        torch.cuda.synchronize()
        prof_decode["wall_ms_per_step"] = (time.perf_counter() - t2) / 8 * 1e3
        if prof_decode["device_us"]:
            prof_decode["busy_share"] = prof_decode["device_us"] / 1e3 / prof_decode[
                "wall_ms_per_step"]
        log(f"  8 decode steps back to back: {prof_decode['wall_ms_per_step']:.2f} ms a step on "
            f"the host clock (busy share {prof_decode.get('busy_share', 'not measured')})   "
            f"[{card}]")

        # 32-layer prefill logits at S=4096: kernels against the plain route,
        # four 512-token chunks (positions 0-2047, K1 at m=512 and K3)
        # and the batcher's routes: a whole 2900-token prompt (bucket 2944) at
        # pos0 0, then, over its first 2048 rows as a prefix hit leaves
        # them, a 1000-token suffix (bucket 1024) at pos0 2048
        got = {}
        for plain in (False, True):
            cache = gpt.init_kv_cache(cfg, 1, 4096, torch.int8, device="cuda")
            for p0 in range(0, 2048, 512):
                logits, _ = gpt.forward(batcher.params, cfg, check_seq[:, p0:p0 + 512],
                                        input_pos=p0,
                                        kv_cache=cache, rope_cache=batcher.rope, plain=plain)
            del cache
            row = fresh_row(torch, batcher)
            whole = batcher_prefill(torch, gpt, batcher, check_seq[:, :2900], 0, row, plain)
            suffix = batcher_prefill(torch, gpt, batcher, check_seq[:, :3048], 2048, row, plain)
            got[plain] = (logits.float(), whole.float(), suffix.float())
            del row
    rel = {}
    for i, name in enumerate(("engine chunk at pos0 1536", "batcher whole prompt 2900",
                              "batcher suffix 1000 at pos0 2048")):
        a, b = got[False][i], got[True][i]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"non-finite prefill logits ({name})")
        rel[name] = float((a - b).abs().max() / b.abs().max())
    log(f"  prefill logits at S=4096, kernels vs plain, max|diff|/max|plain|: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in rel.items())} (tolerance {LOGITS_REL_TOL})")
    if max(rel.values()) > LOGITS_REL_TOL:
        raise AssertionError(f"prefill logits differ beyond {LOGITS_REL_TOL}: {rel}")
    results["serving"] = {
        "model": "Llama-2-7b-hf (random weights, seed 0), q4r1 int4, int8 KV cache, "
                 "block_size 4096",
        "n_slots": N_SLOTS, "decode_quantum": 8, "adaptive_quantum": True, "new_tokens": n_new,
        "http_s": http_s, "http": [{k: v for k, v in a.items() if k != "text"} for a in answers],
        "load": load, "load_prefix": load_prefix, "load_wave": load_wave,
        "prefix_register_ms": register_s * 1e3,
        "prefix_hits": hits, "batched_admissions": batcher.batched_admissions,
        "launches": counts, "peak_gb": peak_gb,
        "engine_checks": checks, "profile_prefill_2048": prof_prefill,
        "profile_decode_step": prof_decode, "prefill_logits_rel_diff": rel, "card": card}
    return counts


# ----------------------------------------------------------------- phase 8
def fastmax_work(bh, n, d, p, chunk, elem, backward: bool) -> tuple:
    """(bytes, operations) of one fastmax call: the function's work, not the
    kernels' tiling. Operations: 4 D (forward) or 10 D (backward) per causal
    (row, key) pair inside a chunk; per row the D x D state products and, for
    p = 2, the pair terms over P = D (D + 1) / 2 pairs m <= j (2 P D each:
    f2 and the S3 update forward; the rewind, dq2, dk2, dv and dS3 backward).
    Bytes: each input read once and each output written once."""
    causal = (n // chunk) * chunk * (chunk + 1) // 2
    pairs = d * (d + 1) // 2
    sym = -(-pairs // 128) * 128  # the packed state's padded rows
    state = 4 * (d * d + d + (sym * d + d * d if p == 2 else 0))
    if backward:
        per_row = (20 if p == 2 else 10) * d * d + ((10 * pairs * d + 11 * pairs) if p == 2 else 0)
        ops = bh * (causal * 10 * d + n * per_row)
        nbytes = bh * (5 * n * d * elem + 4 * n + state + 3 * n * d * elem)
    else:
        per_row = (10 if p == 2 else 4) * d * d + ((4 * pairs * d + 2 * pairs) if p == 2 else 0)
        ops = bh * (causal * 4 * d + n * per_row)
        nbytes = bh * (3 * n * d * elem + n * d * elem + 4 * n + state)
    return nbytes, ops


def fastmax_close(torch, what, got, ref, kind, dt):
    """max|got - ref| and that over max|ref|; raises past the tolerance."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    tol = (FASTMAX_F32_REL if dt == torch.float32 else FASTMAX_BF16_REL)[kind]
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or not rel <= tol:
        raise AssertionError(f"fastmax {what}: max abs err {err:.3e}, {rel:.3e} of the largest "
                             f"value (tolerance {tol})")
    return err, rel


def fastmax_qkv(torch, gen, shape, p, dt):
    """q, k (std FASTMAX_QK_STD[p]), v and the output cotangent (std 1) on the card."""
    std = FASTMAX_QK_STD[p]
    return [(torch.randn(shape, generator=gen, device="cuda") * s).to(dt)
            for s in (std, std, 1.0, 1.0)]


def fastmax_case(torch, gen, shape, p, chunk, dt):
    """K4 and K5 against the plain walks on one random (B, H, N, D) input:
    o through ``fastmax_trainable`` and ``fastmax_forward`` (K4 with and
    without its g and state outputs), dq, dk, dv through the autograd
    backward (K5), and K4's g and final state through its launcher. Raises
    on a mismatch; returns {output: (max abs err, that of the largest value)}
    and, for float32, ``fastmax_f64_errors``."""
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    q, k, v, do = fastmax_qkv(torch, gen, shape, p, dt)
    b, h, n, d = shape
    out = {}
    for plain in (False, True):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fk.fastmax_trainable(*ts, p, 8.0, chunk, plain=plain)
        o.backward(do)
        only = fk.fastmax_forward(q, k, v, p, 8.0, chunk, plain=plain)
        out[plain] = {"o": o.detach(), "o (forward only)": only,
                      "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}
    flat = [x.reshape(b * h, n, d) for x in (q, k, v)]
    z = 8.0 * math.sqrt(d)
    for plain, (_, g, state) in ((False, fk._fwd_launch(*flat, p, z, chunk, train=True)),
                                 (True, fk.fastmax_fwd_plain(*flat, p, z, chunk))):
        out[plain].update(zip(("g", "s_kv", "s_k", "s_kkv", "s_kk"), (g,) + tuple(state)))
    tag = f"B={b} H={h} N={n} D={d} p={p} {str(dt)[6:]}"
    errs = {}
    for name, ref in out[True].items():
        kind = "grad" if name in ("dq", "dk", "dv") else "fwd"
        label = "K5" if kind == "grad" else "K4"
        if kind == "grad" and n // chunk >= 16 and dt == torch.float32:
            kind = "grad, 16 chunks"
        errs[name] = fastmax_close(torch, f"{label} {name} {tag}", out[False][name], ref, kind, dt)
    return errs, (fastmax_f64_errors(torch, q, k, v, do, p, out) if dt == torch.float32 else None)


def fastmax_f64_errors(torch, q, k, v, do, p, out) -> dict:
    """Each route's distance from the O(N^2) reference in float64, of its
    largest value: {output: (kernels, plain)}. A yardstick, not a check."""
    from fastmax_tpu_torch.ops.fastmax import polynomial_attention_reference

    ts = [x.double().requires_grad_(True) for x in (q, k, v)]
    o = polynomial_attention_reference(*ts, p=p, mask=True)
    o.backward(do.double())
    ref = {"o": o.detach(), "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}
    return {name: tuple(float((out[plain][name].double() - r).abs().max() / r.abs().max())
                        for plain in (False, True))
            for name, r in ref.items()}


def fastmax_pair_terms(torch, gen, shape, chunk):
    """The degree-2 terms alone: o, dq, dk, dv at p = 2 minus p = 1 on the same
    f32 inputs (q, k std 1), kernels against plain, held at FASTMAX_PAIR_REL of
    the plain difference's largest value. Returns {output: (that error, the
    difference's largest value over the p = 2 output's)}."""
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    q, k, v, do = fastmax_qkv(torch, gen, shape, 1, torch.float32)
    got = {}
    for plain in (False, True):
        per_p = {}
        for p in (2, 1):
            ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = fk.fastmax_trainable(*ts, p, 8.0, chunk, plain=plain)
            o.backward(do)
            per_p[p] = [o.detach()] + [t.grad for t in ts]
        got[plain] = (per_p[2], [a - b for a, b in zip(per_p[2], per_p[1])])
    errs = {}
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        a, b = got[False][1][i], got[True][1][i]
        rel = float((a - b).abs().max()) / float(b.abs().max())
        share = float(b.abs().max()) / float(got[True][0][i].abs().max())
        if not rel <= FASTMAX_PAIR_REL:
            raise AssertionError(f"fastmax degree-2 terms of {name}: kernels vs plain "
                                 f"{rel:.3e} of the largest value (tolerance {FASTMAX_PAIR_REL})")
        errs[name] = (rel, share)
    return errs


def fastmax_repeats(torch, gen, shape, chunk, runs: int = 3) -> None:
    """K4 and K5 give the same bits on every call (no float atomics: every sum
    has a fixed order); raises otherwise."""
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    q, k, v, do = fastmax_qkv(torch, gen, shape, 2, torch.float32)
    outs = []
    for _ in range(runs):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fk.fastmax_trainable(*ts, 2, 8.0, chunk)
        o.backward(do)
        outs.append([o.detach()] + [t.grad for t in ts])
    for other in outs[1:]:
        for name, a, b in zip(("o", "dq", "dk", "dv"), outs[0], other):
            if not torch.equal(a, b):
                raise AssertionError(f"fastmax {name} differs between two calls on the same "
                                     f"inputs by {float((a - b).abs().max()):.3e}")


def check_fastmax(torch, gen, results):
    from fastmax_tpu_torch.ops import fastmax as tfm
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    train_shape = (4, 8, 512, 64)
    # ((B, H, N, D), p, chunk, dtype): the training shape, p = 1, 16 chunks at D = 16
    cases = [(train_shape, 2, 128, f32), (train_shape, 2, 128, bf16), (train_shape, 1, 128, f32),
             ((1, 2, 2048, 16), 2, 128, f32)]
    checks = []
    for shape, p, chunk, dt in cases:
        errs, f64 = fastmax_case(torch, gen, shape, p, chunk, dt)
        checks.append({"shape": shape, "p": p, "dtype": str(dt)[6:], "errors": errs,
                       "from_f64_kernels_plain": f64})
        log(f"  fastmax {shape} p={p} {str(dt)[6:]}: ok, max abs err (of the largest value) "
            + ", ".join(f"{k} {a:.2e} ({r:.1e})" for k, (a, r) in errs.items()))
        if f64:
            log("    from the float64 O(N^2) reference, of its largest value, kernels / plain: "
                + ", ".join(f"{k} {a:.1e} / {b:.1e}" for k, (a, b) in f64.items()))
    train_errs = checks[0]["errors"]
    own_err = {"fastmax_fwd": max(train_errs[k][0] for k in ("o", "o (forward only)")),
               "fastmax_bwd": max(train_errs[k][0] for k in ("dq", "dk", "dv"))}
    pair = fastmax_pair_terms(torch, gen, train_shape, 128)
    log(f"  fastmax {train_shape} degree-2 terms (p=2 - p=1, q/k std 1) kernels vs plain, of "
        f"the largest value (tolerance {FASTMAX_PAIR_REL}): "
        + ", ".join(f"{k} {r:.2e}" for k, (r, _) in pair.items())
        + "; their share of the p=2 output: "
        + ", ".join(f"{k} {s:.2e}" for k, (_, s) in pair.items()))
    fastmax_repeats(torch, gen, train_shape, 128)
    log(f"  fastmax {train_shape} p=2 f32: o, dq, dk, dv equal bit for bit over 3 calls")
    # a ragged N = 200 through fastmax(): padded to 256 at the tail; output and
    # gradients, kernels against plain
    q, k, v, do = fastmax_qkv(torch, gen, (4, 8, 200, 64), 2, f32)
    got = {}
    for plain in (False, True):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tfm.fastmax(*ts, p=2, plain=plain)
        o.backward(do)
        got[plain] = [o.detach()] + [t.grad for t in ts]
    ragged = {n: fastmax_close(torch, f"fastmax() N=200 {n}", a, b,
                               "fwd" if n == "o" else "grad", f32)
              for n, a, b in zip(("o", "dq", "dk", "dv"), got[False], got[True])}
    log("  fastmax() B=4 H=8 N=200 (padded to 256) D=64 p=2 f32: ok, max abs err (of the "
        "largest value) " + ", ".join(f"{k} {a:.2e} ({r:.1e})" for k, (a, r) in ragged.items()))
    results["fastmax_checks"] = {"cases": checks, "degree2_terms": pair, "ragged_n200": ragged,
                                 "repeat_bitwise": True}

    # device time at the training shape, inputs cold: four input sets (67 MB f32)
    rows = []
    n_sets = 4
    for p, dt in ((2, f32), (2, bf16), (1, f32)):
        sets = [[(torch.randn((32, 512, 64), generator=gen, device=dev) * 0.5).to(dt)
                 for _ in range(4)] for _ in range(n_sets)]
        z = 8.0 * math.sqrt(64)
        fwd_out = [fk.fastmax_fwd_plain(q, k, v, p, z, 128) for q, k, v, _ in sets]
        it = iter(range(10**9))

        def fwd(train=True, plain=False):
            q, k, v, _ = sets[next(it) % n_sets]
            if plain:
                return fk.fastmax_fwd_plain(q, k, v, p, z, 128)
            return fk._fwd_launch(q, k, v, p, z, 128, train=train)

        def bwd(plain=False):
            i = next(it) % n_sets
            q, k, v, do = sets[i]
            o, g, st = fwd_out[i]
            walk = fk.fastmax_bwd_plain if plain else fk._bwd_launch
            return walk(q, k, v, do, o, g, st, p, z, 128)

        k4 = graph_ms(fwd, calls=2 * n_sets)
        k4_only = graph_ms(lambda: fwd(train=False), calls=2 * n_sets)
        plain_f = graph_ms(lambda: fwd(plain=True), calls=n_sets, reps=1)
        k5 = graph_ms(bwd, calls=2 * n_sets)
        plain_b = graph_ms(lambda: bwd(plain=True), calls=n_sets, reps=1)
        elem = 2 if dt == bf16 else 4
        b_f = bound(*fastmax_work(32, 512, 64, p, 128, elem, False), bf16=dt == bf16)
        b_b = bound(*fastmax_work(32, 512, 64, p, 128, elem, True), bf16=dt == bf16)
        rows.append({"p": p, "dtype": str(dt)[6:], "k4_ms": k4, "k4_forward_only_ms": k4_only,
                     "plain_fwd_ms": plain_f, "k5_ms": k5, "plain_bwd_ms": plain_b,
                     "fwd_bound": b_f, "bwd_bound": b_b})
        log(f"  fastmax B=4 H=8 N=512 D=64 p={p} {str(dt)[6:]:8s}: K4 {k4 * 1e3:8.1f} us "
            f"(forward only {k4_only * 1e3:8.1f})  plain {plain_f * 1e3:8.1f} us  bound "
            f"{b_f['bound_ms'] * 1e3:6.1f} us ({b_f['bound_by']}; {b_f['bound_f32_ms'] * 1e3:6.1f} "
            f"at the f32 rate);  K5 {k5 * 1e3:8.1f} us  plain {plain_b * 1e3:8.1f} us  bound "
            f"{b_b['bound_ms'] * 1e3:6.1f} us ({b_b['bound_by']}; "
            f"{b_b['bound_f32_ms'] * 1e3:6.1f} at the f32 rate)")
        del sets, fwd_out
    results["fastmax_times"] = rows
    return own_err, rows


def repo_text_tokens(np):
    """The bytes of the repository's own *.md and *.py files, bytes >= 205
    (the easy-transformer vocabulary) dropped, as uint16 tokens."""
    skip = {"_build", "_checkout", "chiprun_out", "__pycache__"}
    files = sorted(f for f in REPO.rglob("*") if f.suffix in (".md", ".py") and f.is_file()
                   and not skip.intersection(f.relative_to(REPO).parts))
    raw = np.frombuffer(b"".join(f.read_bytes() for f in files), np.uint8)
    return raw[raw < 205].astype(np.uint16), len(files)


def clone_tree(tree, requires_grad: bool):
    if isinstance(tree, dict):
        return {k: clone_tree(v, requires_grad) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(requires_grad)


def train_args():
    """``pretrain.setup``'s defaults, TRAIN_STEPS steps, a log line every step."""
    from fastmax_tpu_torch.utils.args import TrainArgs

    return TrainArgs(global_batch_size=8, micro_batch_size=4, max_iters=TRAIN_STEPS,
                     learning_rate=6e-4, save_interval=1000, log_interval=1)


def training_run(torch, pretrain, build, data, out, model_name, card):
    """TRAIN_STEPS steps of ``pretrain.setup`` with its defaults."""
    import csv

    from fastmax_tpu_torch.utils.args import IOArgs

    gc.collect()  # what earlier phases left in reference cycles (the 7B batcher)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    state = pretrain.setup(model_name=model_name, data_format="openwebtext",
                           train=train_args(), io=IOArgs(train_data_dir=data, out_dir=out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9  # the run's own peak
    with open(out / "metrics.csv", newline="") as f:
        steps = {int(r["step"]): r for r in csv.DictReader(f)}
    losses = [float(steps[s]["loss"]) for s in sorted(steps)]
    step_s = (float(steps[TRAIN_STEPS]["time"]) - float(steps[10]["time"])) / (TRAIN_STEPS - 10)
    tok_s = 8 * 512 / step_s
    run = {"model": model_name, "steps": state.step, "wall_s": wall, "step_s": step_s,
           "tokens_per_s": tok_s, "peak_gb": peak_gb, "held_before_gb": held / 1e9,
           "launches": counts,
           "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
           "est_mfu_logged": float(steps[TRAIN_STEPS].get("est_mfu") or "nan"), "card": card}
    log(f"  {model_name}: {state.step} steps in {wall:.2f} s; steps 11-{TRAIN_STEPS}: "
        f"{step_s * 1e3:.2f} ms a step, {tok_s:.1f} tokens/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; peak {peak_gb:.3f} GB; launches {counts}   [{card}]")
    return state, run


def step_kernels_vs_plain(torch, cfg, batch, seed: int = 1337) -> dict:
    """One training step's loss and every gradient, kernels against
    ``plain=True``, f32, from ``init_params(seed)`` with the qkv weights scaled
    to a standard deviation of sqrt(8 / n_embd): q and k then have one of about
    sqrt(8) and s = q.k / z one of about 1 (at the init std 0.02 it is about
    0.025, where the degree-2 terms would hardly show). Raises past
    TRAIN_LOSS_REL or TRAIN_GRAD_REL."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.training.step import make_loss_fn, tree_leaves

    params0 = gpt.init_params(cfg, seed=seed, device="cuda")
    qkv = params0["blocks"]["attn"]["attn"]["kernel"]
    qkv.mul_(math.sqrt(8.0 / cfg.n_embd) / float(qkv.std()))
    res = {}
    for plain in (False, True):
        ps = clone_tree(params0, True)
        loss = make_loss_fn(cfg, remat=True, plain=plain)(ps, batch)
        loss.backward()
        res[plain] = (float(loss.detach()), [p.grad for p in tree_leaves(ps)])
    loss_rel = abs(res[False][0] - res[True][0]) / abs(res[True][0])
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(res[False][1], res[True][1]))
    log(f"  one step, kernels vs plain (qkv std sqrt(8/n_embd)): loss {res[False][0]:.6f} vs "
        f"{res[True][0]:.6f} (rel {loss_rel:.2e}, tolerance {TRAIN_LOSS_REL}); worst gradient "
        f"leaf max|diff|/max|plain| {grad_rel:.2e} (tolerance {TRAIN_GRAD_REL})")
    if not (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL):
        raise AssertionError(f"kernels vs plain: loss rel {loss_rel}, grad rel {grad_rel}")
    return {"loss": [res[False][0], res[True][0]], "loss_rel": loss_rel, "worst_grad_rel": grad_rel}


def training_path(torch, results, card):
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import pretrain
    from fastmax_tpu_torch.training.fit import build_optimizer
    from fastmax_tpu_torch.training.step import make_loss_fn, tree_leaves
    from fastmax_tpu_torch.utils.flops import estimate_flops

    cfg = Config.from_name("easy-transformer-fastmax")
    tokens, n_files = repo_text_tokens(np)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        data.mkdir()
        tokens.tofile(data / "train.bin")
        (data / "meta.json").write_text('{"dtype": "uint16"}')
        log(f"  train.bin: {tokens.size} tokens from {n_files} *.md/*.py files of the repository")
        state, run = training_run(torch, pretrain, build, data, Path(tmp) / "fm",
                                  "easy-transformer-fastmax", card)
        n_params = sum(p.numel() for p in tree_leaves(state.params))
        flops_tok = estimate_flops(cfg, n_params, 512) / 512
        run["mfu_f32"] = run["tokens_per_s"] * flops_tok / F32_FLOPS_PER_S
        mb = TRAIN_STEPS * 2
        want = {"fastmax_fwd": 2 * cfg.n_layer * mb, "fastmax_bwd": cfg.n_layer * mb}
        log(f"  easy-transformer-fastmax: {n_params} parameters, {flops_tok / 1e6:.1f} MFLOP a "
            f"token (6N + attention, the reference's count), MFU {run['mfu_f32']:.4f} of the "
            f"f32 peak; K4/K5 launches {run['launches']['fastmax_fwd']}/"
            f"{run['launches']['fastmax_bwd']} (remat: {want['fastmax_fwd']}/"
            f"{want['fastmax_bwd']})   [{card}]")
        if {k: run["launches"][k] for k in want} != want:
            raise AssertionError(f"K4/K5 launches {run['launches']} != {want}")
        if not run["last_loss"] < run["first_loss"]:
            raise AssertionError(f"the loss did not fall: {run['losses']}")

        # one step's device time by kernel group, and the busy share
        loss_fn = make_loss_fn(cfg, remat=True)
        leaves = tree_leaves(state.params)
        batches = [torch.as_tensor(tokens[i * 2052:(i + 1) * 2052].astype(np.int64),
                                   device="cuda").reshape(4, 513) for i in range(2)]
        optimizer = build_optimizer(train_args())

        def one_step():
            for p in leaves:
                p.grad = None
            for b in batches:
                loss_fn(state.params, b).backward()
            optimizer.update(state.params, [p.grad / 2 for p in leaves], state.opt_state)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_device(torch, one_step, "one training step (2 micro-batches)")
        prof["wall_ms"] = wall_ms
        if prof["device_us"]:
            prof["busy_share"] = prof["device_us"] / 1e3 / wall_ms
        log(f"  one step: {wall_ms:.2f} ms on the host clock, device busy share "
            f"{prof.get('busy_share', 'not measured')}   [{card}]")
        run["profile_step"] = prof
        del state, leaves, optimizer
        out["fastmax"] = run

        # one step's loss and every gradient: kernels against plain=True
        out["kernels_vs_plain"] = step_kernels_vs_plain(torch, cfg, batches[0])

        # the yardstick: the same 40 steps with quadratic attention
        _, quad = training_run(torch, pretrain, build, data, Path(tmp) / "quad",
                               "easy-transformer", card)
        out["quadratic"] = quad
        log(f"  tokens/s: easy-transformer-fastmax {run['tokens_per_s']:.1f}, easy-transformer "
            f"(quadratic) {quad['tokens_per_s']:.1f}   [{card}]")
    results["training"] = out
    return run["launches"]


# ----------------------------------------------------------------- phase 9
# K6/K7 against the plain versions. q and k are drawn at std sqrt(3), so the
# scores q.k / sqrt(D) have a standard deviation of about 3: rows put most of
# their weight on a few keys, where a missing mask, delta or rounding shows.
# v and the output cotangent have std 1. Each output is held by max|kernel -
# plain| over its largest value: float32 1e-5 (out, lse) and 1e-4 (dq, dk, dv,
# whose ds terms cancel); bfloat16 2^-7, one bf16 ulp of any element (the
# outputs are rounded values, and two f32 sums in other orders round to
# neighbours now and then), and, since such a flip is rare where a rounding
# step is missing it is not, also by mean|kernel - plain| over mean|plain| at
# FLASH_TRAIN_BF16_MEAN (a missing rounding of p moves dv by about 2^-9 of a
# term: ~1e-3 of the mean). lse is f32 in both: 1e-5.
FLASH_TRAIN_QK_STD = 3.0 ** 0.5
FLASH_TRAIN_REL = {"float32": {"out": 1e-5, "grad": 1e-4}, "bfloat16": {"out": 2.0 ** -7,
                                                                        "grad": 2.0 ** -7}}
FLASH_TRAIN_LSE_REL = 1e-5
FLASH_TRAIN_BF16_MEAN = 5e-5
FT_SHAPE = (2, 32, 2048, 128)   # micro-batch 2 of Llama-2-7B at T = 2048
FT_STEPS = 4
# one step of the 4-layer QLoRA model, kernels against plain=True: the loss
# (relative) and each LoRA gradient leaf (of its largest entry). f32: sums in
# other orders; bf16: every activation is rounded, and a flipped attention
# output element moves what follows by a bf16 ulp.
FT_STEP_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (5e-3, 5e-2)}
K6_K7 = {"out": "K6", "lse": "K6", "dq": "K7", "dk": "K7", "dv": "K7"}


def flash_train_fn(entry: str, d: int, plain: bool):
    from fastmax_tpu_torch.ops import flash_attention as fa
    from fastmax_tpu_torch.ops.attention import attention

    if entry == "fused":
        return lambda q, k, v: fa.flash_attention_fused(q, k, v, plain=plain)
    if entry == "trainable":
        return lambda q, k, v: fa.flash_attention_trainable(q, k, v, plain=plain)
    return lambda q, k, v: attention(q, k, v, attn_alg="quadratic", head_size=d, plain=plain)


def flash_train_run(fn, q, k, v, w) -> dict:
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fn(*ts)
    o.backward(w)
    return {"out": o.detach(), "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}


def flash_train_inputs(torch, gen, shape, dtype):
    s = FLASH_TRAIN_QK_STD
    return [(torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)
            for std in (s, s, 1.0, 1.0)]


def flash_train_f64(torch, q, k, v, w, res) -> dict:
    """Each route's distance from dense causal softmax attention in float64 on
    the same inputs, of the reference's largest value: {output: (kernels,
    plain)}. A yardstick, not a check."""
    t, d = q.shape[2], q.shape[3]
    ts = [x.double().requires_grad_(True) for x in (q, k, v)]
    s = torch.einsum("bhid,bhjd->bhij", ts[0], ts[1]) * d ** -0.5
    s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=q.device).tril(), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhij,bhjd->bhid", torch.exp(s - lse[..., None]), ts[2])
    o.backward(w.double())
    ref = {"out": o.detach(), "lse": lse.detach(), "dq": ts[0].grad, "dk": ts[1].grad,
           "dv": ts[2].grad}
    del s, o
    return {name: tuple(float((res[plain][name].double() - r).abs().max() / r.abs().max())
                        for plain in (False, True))
            for name, r in ref.items() if name in res[False]}


def flash_train_case(torch, gen, entry, shape, dtype, f64: bool = True) -> dict:
    """K6 and K7 through ``entry`` ("fused", "trainable" or "attention": the
    dispatch, which pads T) against plain=True on one random input: out,
    dq, dk, dv (the autograd backward) and, for the entries, lse (K6 launched
    once more by itself). Raises on a mismatch; returns {output: (max abs
    err, that of the largest value, mean err of the mean)} and the float64
    yardstick."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    q, k, v, w = flash_train_inputs(torch, gen, shape, dtype)
    d = shape[3]
    res = {plain: flash_train_run(flash_train_fn(entry, d, plain), q, k, v, w)
           for plain in (False, True)}
    if entry != "attention":
        block = fa._fused_block(shape[2]) if entry == "fused" else fa.DEFAULT_BLOCK_K
        res[False]["lse"] = fa._train_fwd(q, k, v, d ** -0.5, block, False)[1]
        res[True]["lse"] = fa.flash_train_fwd_plain(q, k, v, d ** -0.5, block)[1]
    torch.cuda.synchronize()
    dt = str(dtype)[6:]
    tag = f"{entry} B={shape[0]} H={shape[1]} T={shape[2]} D={d} {dt}"
    errs = {}
    for name, ref in res[True].items():
        got = res[False][name]
        err = (got.float() - ref.float()).abs()
        max_abs = float(err.max())
        rel = max_abs / max(float(ref.float().abs().max()), 1e-30)
        mean = float(err.mean()) / max(float(ref.float().abs().mean()), 1e-30)
        tol = FLASH_TRAIN_LSE_REL if name == "lse" else \
            FLASH_TRAIN_REL[dt]["out" if name == "out" else "grad"]
        bad = (got.shape != ref.shape or got.dtype != ref.dtype
               or not bool(torch.isfinite(got).all()) or not rel <= tol)
        if dtype == torch.bfloat16 and name != "lse" and not mean <= FLASH_TRAIN_BF16_MEAN:
            bad = True
        if bad:
            raise AssertionError(
                f"{K6_K7[name]} {name} {tag}: max abs err {max_abs:.3e}, {rel:.3e} of the largest "
                f"value (tolerance {tol}), mean err {mean:.3e} of the mean")
        errs[name] = (max_abs, rel, mean)
    yard = flash_train_f64(torch, q, k, v, w, res) if f64 else None
    del res
    return {"case": tag, "errors": errs, "from_f64_kernels_plain": yard}


def flash_train_repeats(torch, gen, shape, dtype, runs: int = 3) -> None:
    """K6 and K7 give the same bits on every call (no atomics); raises otherwise."""
    q, k, v, w = flash_train_inputs(torch, gen, shape, dtype)
    fn = flash_train_fn("fused", shape[3], False)
    outs = [flash_train_run(fn, q, k, v, w) for _ in range(runs)]
    for other in outs[1:]:
        for name in outs[0]:
            if not torch.equal(outs[0][name], other[name]):
                raise AssertionError(f"{K6_K7[name]} {name} differs between two calls on the "
                                     "same inputs")


def flash_train_work(b, h, t, d, elem, backward: bool) -> tuple:
    """(bytes, operations) of one call: 4 D (forward) or 10 D (backward: s, dp,
    dv, dk, dq) flops per visible (row, key) pair; each input read once and
    each output written once (lse and delta f32)."""
    pairs = b * h * t * (t + 1) // 2
    n = b * h * t * d
    if backward:
        return elem * 7 * n + 4 * 2 * b * h * t, 10 * d * pairs
    return elem * 4 * n + 4 * b * h * t, 4 * d * pairs


def flash_train_times(torch, gen, dtype, n_sets: int = 4) -> dict:
    """Device time per call in a CUDA graph, inputs cold (n_sets input sets,
    128 MB in bf16), at the finetune shape: K6 (the fused entry's block, and
    the other entry's 128-key block), K7, their plain versions, and SDPA's
    causal forward and forward + backward (autograd captured in the graph)."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    b, h, t, d = FT_SHAPE
    scale, blk = d ** -0.5, fa._fused_block(t)
    sets = []
    for _ in range(n_sets):
        q, k, v, w = flash_train_inputs(torch, gen, FT_SHAPE, dtype)
        out, lse = fa._train_fwd(q, k, v, scale, blk, False)
        sets.append((q, k, v, w, lse, torch.sum(w.float() * out.float(), dim=-1)))
    it = iter(range(10**9))

    def fwd(plain=False, block=blk):
        q, k, v, *_ = sets[next(it) % n_sets]
        return fa._train_fwd(q, k, v, scale, block, plain)

    def bwd(plain=False):
        q, k, v, w, lse, delta = sets[next(it) % n_sets]
        return fa._train_bwd(q, k, v, w, lse, delta, scale, plain)

    def lib_fwd():
        q, k, v, *_ = sets[next(it) % n_sets]
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                scale=scale)

    def lib_fwd_bwd():
        q, k, v, w, *_ = sets[next(it) % n_sets]
        ts = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.nn.functional.scaled_dot_product_attention(*ts, is_causal=True,
                                                         scale=scale).backward(w)

    elem = 2 if dtype == torch.bfloat16 else 4
    row = {"dtype": str(dtype)[6:], "shape": FT_SHAPE,
           "k6_ms": graph_ms(fwd, calls=2 * n_sets),
           "k6_block128_ms": graph_ms(lambda: fwd(block=fa.DEFAULT_BLOCK_K), calls=2 * n_sets),
           "plain_fwd_ms": graph_ms(lambda: fwd(plain=True), calls=n_sets, reps=1),
           "k7_ms": graph_ms(bwd, calls=2 * n_sets),
           "plain_bwd_ms": graph_ms(lambda: bwd(plain=True), calls=n_sets, reps=1),
           "sdpa_fwd_ms": graph_ms(lib_fwd, calls=2 * n_sets),
           "sdpa_fwd_bwd_ms": graph_ms(lib_fwd_bwd, calls=2 * n_sets),
           "sdpa_backend": sdpa_backend(torch, *sets[0][:3], None, scale, is_causal=True),
           "fwd_bound": bound(*flash_train_work(b, h, t, d, elem, False), bf16=elem == 2),
           "bwd_bound": bound(*flash_train_work(b, h, t, d, elem, True), bf16=elem == 2)}
    del sets
    return row


def check_flash_train(torch, gen, results):
    f32, bf16 = torch.float32, torch.bfloat16
    # (entry, (B, H, T, D), dtype): the finetune shape through both entries in
    # both types; T=1088 through attention() (padded to 1536); D=64; 192, 256
    cases = [("fused", FT_SHAPE, bf16), ("fused", FT_SHAPE, f32),
             ("trainable", FT_SHAPE, bf16), ("trainable", FT_SHAPE, f32),
             ("attention", (2, 32, 1088, 128), bf16), ("fused", (4, 32, 2048, 64), bf16),
             ("fused", (1, 8, 1024, 256), bf16), ("trainable", (1, 8, 640, 192), f32)]
    checks = []
    for entry, shape, dt in cases:
        c = flash_train_case(torch, gen, entry, shape, dt, f64=entry != "attention")
        checks.append(c)
        log(f"  {c['case']}: ok; max abs err (of the largest; mean of the mean) "
            + ", ".join(f"{k} {a:.2e} ({r:.1e}; {m:.1e})" for k, (a, r, m) in c["errors"].items()))
        if c["from_f64_kernels_plain"]:
            log("    from float64 dense attention, of its largest value, kernels / plain: "
                + ", ".join(f"{k} {a:.1e} / {b:.1e}"
                            for k, (a, b) in c["from_f64_kernels_plain"].items()))
    flash_train_repeats(torch, gen, FT_SHAPE, bf16)
    log(f"  fused {FT_SHAPE} bf16: out, dq, dk, dv equal bit for bit over 3 calls")
    rows = []
    for dt in (bf16, f32):
        r = flash_train_times(torch, gen, dt)
        rows.append(r)
        fb, bb = r["fwd_bound"], r["bwd_bound"]
        log(f"  {FT_SHAPE} {r['dtype']:8s}: K6 {r['k6_ms'] * 1e3:9.1f} us (128-key blocks "
            f"{r['k6_block128_ms'] * 1e3:9.1f})  plain "
            f"{r['plain_fwd_ms'] * 1e3:9.1f}  SDPA ({r['sdpa_backend']}) "
            f"{r['sdpa_fwd_ms'] * 1e3:8.1f}  bound {fb['bound_ms'] * 1e3:7.1f} ({fb['bound_by']}; "
            f"{fb['bound_f32_ms'] * 1e3:7.1f} at the f32 rate);  K7 {r['k7_ms'] * 1e3:9.1f} us  "
            f"plain {r['plain_bwd_ms'] * 1e3:9.1f}  SDPA forward+backward "
            f"{r['sdpa_fwd_bwd_ms'] * 1e3:8.1f}  bound {bb['bound_ms'] * 1e3:7.1f} "
            f"({bb['bound_by']}; {bb['bound_f32_ms'] * 1e3:7.1f} at the f32 rate)")
    results["flash_train_checks"] = {"cases": checks, "repeat_bitwise": True}
    results["flash_train_times"] = rows
    main = checks[0]["errors"]  # the finetune shape, bf16, fused: the path's
    own = {"flash_train_fwd": max(main[k][0] for k in ("out", "lse")),
           "flash_train_bwd": max(main[k][0] for k in ("dq", "dk", "dv"))}
    return own, rows


def sft_examples(np, n: int = 48, seed: int = 0):
    """SFT examples from the repository's own text (``repo_text_tokens``) as
    Llama's byte-fallback ids (byte + 3): lengths drawn from 1100..2600, the
    first quarter of each example's labels masked (-1)."""
    tokens, _ = repo_text_tokens(np)
    ids = tokens.astype(np.int64) + 3
    rng = np.random.default_rng(seed)
    examples, off = [], 0
    for _ in range(n):
        length = int(rng.integers(1100, 2601))
        if off + length > ids.size:
            off = 0
        x = ids[off:off + length]
        off += length
        labels = x.copy()
        labels[: length // 4] = -1
        examples.append({"input_ids": x, "labels": labels})
    return examples, ids.size


def finetune_step_vs_plain(torch, batch, dtype, seed: int = 1337) -> dict:
    """One step of the QLoRA model cut to 4 layers, kernels against plain=True:
    the loss and every LoRA gradient. lora_B is drawn (std 0.02) so that the
    deltas reach the output and lora_A gets a gradient; the NF4 absmax of the
    qkv weights is scaled so that the dequantized weights have a standard
    deviation of 1/sqrt(n_embd): q and k then have one of about 1 and the
    scores one of about 1."""
    from fastmax_tpu_torch.models import gpt, lora
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops.quant import dequantize, quantize_model
    from fastmax_tpu_torch.training.finetune import sft_loss_fn
    from fastmax_tpu_torch.training.step import tree_leaves

    cfg = Config.from_name("Llama-2-7b-hf", n_layer=4, attn_alg="quadratic")
    params = quantize_model(gpt.init_params(cfg, seed, dtype, "cuda"), "bnb.nf4")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = lora.add_lora_params(params, cfg, lora.LoRAConfig(r=8, alpha=16.0), gen, dtype)
    qkv = params["blocks"]["attn"]["attn"]
    w_std = float(dequantize({k: v[0] for k, v in qkv.items() if not k.startswith("lora")}).std())
    qkv["absmax"] = qkv["absmax"] * (cfg.n_embd ** -0.5 / w_std)
    qkv["lora_B"] = (torch.randn(qkv["lora_B"].shape, generator=gen, device="cuda")
                     * 0.02).to(dtype)
    mask = tree_leaves(lora.trainable_mask(params))
    res = {}
    for plain in (False, True):
        ps = clone_tree(params, False)
        leaves = tree_leaves(ps)
        for p, m in zip(leaves, mask):
            p.requires_grad_(m)
        loss = sft_loss_fn(cfg, plain=plain)(ps, batch)
        loss.backward()
        res[plain] = (float(loss.detach()), [p.grad for p, m in zip(leaves, mask) if m])
    loss_tol, grad_tol = FT_STEP_TOL[str(dtype)[6:]]
    loss_rel = abs(res[False][0] - res[True][0]) / abs(res[True][0])
    grad_rel = max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                   1e-30)
                   for a, b in zip(res[False][1], res[True][1]))
    log(f"  one step, 4 layers, {str(dtype)[6:]}, kernels vs plain: loss {res[False][0]:.6f} vs "
        f"{res[True][0]:.6f} (rel {loss_rel:.2e}, tolerance {loss_tol}); worst LoRA gradient "
        f"leaf max|diff|/max|plain| {grad_rel:.2e} (tolerance {grad_tol})")
    if not (math.isfinite(res[False][0]) and loss_rel <= loss_tol and grad_rel <= grad_tol):
        raise AssertionError(f"kernels vs plain: loss rel {loss_rel}, grad rel {grad_rel}")
    return {"loss": [res[False][0], res[True][0]], "loss_rel": loss_rel,
            "worst_grad_rel": grad_rel, "qkv_weight_std_before": w_std}


def finetune_path(torch, results, card):
    import csv
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.data.lm_datasets import SFTDataset
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import lora
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.training.fit import build_optimizer
    from fastmax_tpu_torch.training.step import tree_leaves
    from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs
    from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint

    cfg = Config.from_name("Llama-2-7b-hf")
    examples, n_tokens = sft_examples(np)
    train = TrainArgs(global_batch_size=8, micro_batch_size=2, max_iters=FT_STEPS,
                      learning_rate=3e-4, save_interval=1000, log_interval=1,
                      max_seq_length=2048)
    run = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "sft.npz"
        np.savez(data, examples=np.array(examples, dtype=object))
        log(f"  sft.npz: {len(examples)} examples of 1100-2600 tokens from {n_tokens} bytes of the "
            "repository's *.md/*.py files (those below 205)")
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        out = Path(tmp) / "ft"
        t0 = time.perf_counter()
        state = finetune.setup(method="lora", model_name="Llama-2-7b-hf", data_path=data,
                               quantize="bnb.nf4", attn_alg="quadratic", precision="bfloat16",
                               lora_r=8, lora_alpha=16.0, lora_query=True, lora_value=True,
                               train=train, io=IOArgs(out_dir=out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        with open(out / "metrics.csv", newline="") as f:
            steps = {int(r["step"]): r for r in csv.DictReader(f)}
        losses = [float(steps[s]["loss"]) for s in sorted(steps)]
        dt = float(steps[FT_STEPS]["time"]) - float(steps[1]["time"])
        toks = float(steps[FT_STEPS]["tokens"]) - float(steps[1]["tokens"])
        step_s, tok_s = dt / (FT_STEPS - 1), toks / dt
        mb = FT_STEPS * train.gradient_accumulation_iters()
        want = {"flash_train_fwd": 2 * cfg.n_layer * mb, "flash_train_bwd": cfg.n_layer * mb}
        lora_b = state.params["blocks"]["attn"]["attn"]["lora_B"]
        moved = float(lora_b.detach().float().abs().max())
        _, delta = lora.split_lora_state(state.params)
        back = load_flat_checkpoint(out / "lora_weights.safetensors")
        flat = finetune._flatten(delta)
        same = sorted(back) == sorted(flat) and all(
            torch.equal(back[n], flat[n].detach().cpu()) for n in flat)
        log(f"  finetune.setup: {state.step} steps in {wall:.2f} s (setup included); steps 2-"
            f"{FT_STEPS}: {step_s * 1e3:.1f} ms a step, {tok_s:.1f} tokens/s; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak {peak_gb:.3f} GB; max|lora_B| {moved:.3e}; "
            f"launches {counts} (want {want}); lora_weights.safetensors: {len(back)} tensors "
            f"read back {'equal' if same else 'DIFFERENT'}   [{card}]")
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"K6/K7 launches {counts} != {want}")
        if not all(math.isfinite(x) for x in losses) or not moved > 0 or not same:
            raise AssertionError(f"finetune: losses {losses}, max|lora_B| {moved}, "
                                 f"checkpoint read back {same}")
        run.update({"model": "Llama-2-7b-hf (random weights, seed 1337), bnb.nf4, bf16",
                    "lora": {"r": 8, "alpha": 16.0, "query": True, "value": True},
                    "steps": state.step, "wall_s": wall, "step_s": step_s,
                    "tokens_per_s": tok_s, "peak_gb": peak_gb, "held_before_gb": held / 1e9,
                    "launches": counts, "losses": losses, "lora_b_max": moved,
                    "checkpoint_read_back": same, "card": card})

        # one step's device time by kernel group, and the busy share
        trainable = lora.trainable_mask(state.params)
        ds = SFTDataset.load(data, 7)
        batches = [tuple(torch.as_tensor(x, device="cuda") for x in ds.sample_batch(2, 2048))
                   for _ in range(train.gradient_accumulation_iters())]
        loss_fn = finetune.sft_loss_fn(cfg)
        optimizer = build_optimizer(train, trainable)
        leaves = tree_leaves(state.params)
        mask = tree_leaves(trainable)

        def one_step():
            for p in leaves:
                p.grad = None
            for b in batches:
                loss_fn(state.params, b).backward()
            optimizer.update(state.params, [p.grad / len(batches) if m else None
                                            for p, m in zip(leaves, mask)], state.opt_state)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_device(torch, one_step, "one finetune step (4 micro-batches)")
        prof["wall_ms"] = wall_ms
        prof["batch_t"] = [int(b[0].shape[1]) for b in batches]
        if prof["device_us"]:
            prof["busy_share"] = prof["device_us"] / 1e3 / wall_ms
        log(f"  one step (T {prof['batch_t']}): {wall_ms:.1f} ms on the host clock, device busy "
            f"share {prof.get('busy_share', 'not measured')}   [{card}]")
        run["profile_step"] = prof
        del state, leaves, optimizer, trainable
        gc.collect()
        torch.cuda.empty_cache()
        batch = batches[0]
        run["step_vs_plain"] = {str(dt)[6:]: finetune_step_vs_plain(torch, batch, dt)
                                for dt in (torch.bfloat16, torch.float32)}
    results["finetune"] = run
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "fastmax_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no fastmax_tpu_torch package beside {Path(__file__).name}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fastmax_tpu_torch.kernels import build

    t_start = time.perf_counter()
    results = {}
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[2] built {sorted(logs)} in {build_s:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    results["build_s"] = build_s

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log("[3] int4 rank-1 matmul kernel vs plain")
    int4_err, int4_rows = check_int4(torch, gen, results)
    log("[4] int8 decode attention kernel vs plain")
    attn_err, attn_rows = check_attention(torch, gen, results)
    log("[5] batch-1 path: Llama-2-7B int4, int8 KV cache, block_size 1024, generate")
    counts_b1 = main_path(torch, results, card)
    log("[6] flash prefill attention kernel vs plain")
    flash_err, flash_rows = check_flash(torch, gen, results)
    log(f"[7] serving path: Llama-2-7B int4 at 4096 context, {N_SLOTS}-slot batcher, HTTP")
    counts = serving_path(torch, results, card)
    log("[8] training: fastmax kernels vs plain, then pretrain.setup on easy-transformer-fastmax")
    fm_err, fm_rows = check_fastmax(torch, gen, results)
    counts_train = training_path(torch, results, card)
    log("[9] finetuning: trainable flash kernels K6/K7 vs plain, then finetune.setup on a QLoRA "
        "Llama-2-7B")
    ft_err, ft_rows = check_flash_train(torch, gen, results)
    counts_ft = finetune_path(torch, results, card)
    results["launches"] = {"batch1_path": counts_b1, "serving_path": counts,
                           "training_path": counts_train, "finetune_path": counts_ft}

    # K1: one decode step of one layer at m=1 (the four linears); K2: pos 191;
    # K3: the five timed 7B calls of phase 6; K4, K5: one call at the training
    # shape (p=2, f32), with each one's own max abs error there (K4: o, K5: dq,
    # dk, dv); K6, K7: one call at the finetune shape (bf16, the path's type), with their
    # own max abs errors there (K6: out, lse; K7: dq, dk, dv); their library time is SDPA's
    # causal forward, and for K7 its forward + backward less that forward. Launches: the
    # serving path (K1-K3), the training path (K4, K5), the finetune path (K6, K7).
    # The bound of several calls is the sum of theirs, bound by the term that
    # bounds most of it.
    dec = [r for r in int4_rows if r["m"] == 1]
    att = next(r for r in attn_rows if r["pos"] == 191)
    k1, k2 = build.KERNELS["int4_rank1_matmul"], build.KERNELS["int8_decode_attention"]
    k3 = build.KERNELS["flash_attention"]

    def bound_by(rows):
        by = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            by[r["bound_by"]] += r["bound_ms"]
        return max(by, key=by.get)
    kernels = [
        {"name": k1.name, "route": "cuda", "source": str(k1.source.relative_to(REPO)),
         "replaces": k1.replaces, "launches": counts[k1.name], "max_abs_err": int4_err,
         "ms": sum(r["ms"] for r in dec), "plain_ms": sum(r["plain_ms"] for r in dec),
         "bound_ms": sum(r["bound_ms"] for r in dec), "bound_by": bound_by(dec),
         "library_ms": None},
        {"name": k2.name, "route": "cuda", "source": str(k2.source.relative_to(REPO)),
         "replaces": k2.replaces, "launches": counts[k2.name], "max_abs_err": attn_err,
         "ms": att["ms"], "plain_ms": att["plain_ms"], "bound_ms": att["bound_ms"],
         "bound_by": att["bound_by"], "library_ms": None},
        {"name": k3.name, "route": "cuda", "source": str(k3.source.relative_to(REPO)),
         "replaces": k3.replaces, "launches": counts[k3.name], "max_abs_err": flash_err,
         "ms": sum(r["ms"] for r in flash_rows), "plain_ms": sum(r["plain_ms"] for r in flash_rows),
         "bound_ms": sum(r["bound_ms"] for r in flash_rows),
         "bound_by": bound_by(flash_rows),
         "library_ms": sum(r["library_ms"] for r in flash_rows)},
    ]
    train_row = next(r for r in fm_rows if r["p"] == 2 and r["dtype"] == "float32")
    for kern, ms, plain_ms, bnd in (
            (build.KERNELS["fastmax_fwd"], train_row["k4_ms"], train_row["plain_fwd_ms"],
             train_row["fwd_bound"]),
            (build.KERNELS["fastmax_bwd"], train_row["k5_ms"], train_row["plain_bwd_ms"],
             train_row["bwd_bound"])):
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": str(kern.source.relative_to(REPO)), "replaces": kern.replaces,
                        "launches": counts_train[kern.name], "max_abs_err": fm_err[kern.name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
                        "bound_by": bnd["bound_by"], "library_ms": None})
    ft = next(r for r in ft_rows if r["dtype"] == "bfloat16")
    for kern, ms, plain_ms, bnd, lib in (
            (build.KERNELS["flash_train_fwd"], ft["k6_ms"], ft["plain_fwd_ms"], ft["fwd_bound"],
             ft["sdpa_fwd_ms"]),
            (build.KERNELS["flash_train_bwd"], ft["k7_ms"], ft["plain_bwd_ms"], ft["bwd_bound"],
             ft["sdpa_fwd_bwd_ms"] - ft["sdpa_fwd_ms"])):
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": str(kern.source.relative_to(REPO)), "replaces": kern.replaces,
                        "launches": counts_ft[kern.name], "max_abs_err": ft_err[kern.name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
                        "bound_by": bnd["bound_by"], "library_ms": lib})
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    log(f"total {results['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
