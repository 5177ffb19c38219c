"""Round-4 NF4 decode-kernel lab (counterpart of ``tools/nf4_lab_r04.py``), on
the card.

Measures per-matmul time and effective read rate of candidate implementations
of the decode-critical quantized matmul at the Llama-2-7B decode shapes
(engine layout: fused qkv / proj / fused gate+up / mlp down).

Timing: each measurement stacks L copies of the weights, L sized so that one
sweep over them reads more than ``WSET`` (384 MB, well past the card's 50 MB
L2: no weight is read from the cache, which would fake the rate of a small
layer such as attn.proj's 8.4 MB), captures one sweep of L chained calls (each
x picks up 1e-30 of the last output) in a CUDA graph, replays it TOTAL_REPS / L
times, and divides the best of ``iters`` such runs by the calls.

Impls: ``bf16``, ``int8``, ``int4`` and ``nf4_xla`` are plain PyTorch (the
reference computes them outside any Pallas kernel): ``torch.matmul``, the
port's ``int8_matmul``, an int8-held int4 matmul, dequantize + matmul.
``nf4_v0`` is ``quantized_matmul_pallas`` (K8), ``stream`` the read-rate
probe (K13), ``v1``-``v12`` the variants of ``nf4_variants_r04``.

Usage: python -m fastmax_tpu_torch.tools.nf4_lab_r04 [impl ...] [--shapes qkv,proj,fc,down]
Each result prints one JSON line: {impl, m, k, n, us, gbps_read,
gbps_per_param, launches, calls}, or {impl, m, k, n, error} / {..., skip}.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ..ops import quant
from ..ops import quant_kernels
from . import _timing
from . import nf4_variants_r04 as V
from . import lab_kernels

SHAPES = {
    "qkv": (4096, 12288),
    "proj": (4096, 4096),
    "fc": (4096, 22016),
    "down": (11008, 4096),
}

WSET = 384 * 2**20  # bytes of one sweep over the stacked copies: well past the 50 MB L2
TOTAL_REPS = 1024
_OVERHEAD = [0.0]


def calibrate():
    """The reference measures its runtime's fixed dispatch + sync cost here and
    subtracts it from each timing; CUDA events around graph replays carry no
    such cost, so it is 0."""
    _OVERHEAD[0] = 0.0
    return _OVERHEAD[0]


def repeat_timer(matmul_stacked, weights, x, bytes_per, iters=5, total_reps=None):
    """Time one matmul amortized over a sweep of the stacked weights (each
    leaf of ``weights`` carries a leading L axis). Returns (seconds a call,
    calls made to matmul_stacked)."""
    L = next(iter(weights.values())).shape[0]
    ro = max(1, (total_reps or TOTAL_REPS) // L)
    fn = _timing.Counted(matmul_stacked)
    layers = [{key: v[i] for key, v in weights.items()} for i in range(L)]

    def sweep():
        carry = x
        for w in layers:
            y = fn(carry, w)
            carry = carry + (y.reshape(-1)[0] * 1e-30).to(carry.dtype)

    graph = _timing.capture(sweep)
    best = _timing.replay_s(graph, iters, times=ro)
    del graph
    return max(best - _OVERHEAD[0], best * 0.25) / (L * ro), fn.calls


def stack_weights(w, bytes_per):
    L = max(4, int(math.ceil(WSET / max(bytes_per, 1))))
    return {key: a[None].expand((L,) + tuple(a.shape)).clone() for key, a in w.items()}


def make_q4(k, n, gen):
    dev = gen.device
    packed = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.int32
                           ).to(torch.uint8)
    absmax = torch.rand((k // 64, n), generator=gen, device=dev) * 0.02 + 0.01
    code = torch.as_tensor(quant.NF4_CODE, device=dev)
    return {"q4": packed, "absmax": absmax, "code": code}


def bytes_read(impl, k, n):
    if impl == "bf16":
        return 2 * k * n
    if impl == "int8":
        return k * n + 4 * n
    if impl == "int4":
        return k * n // 2 + 4 * n
    return k * n // 2 + (k // 64) * n * 4


def run_one(impl, fn, weights, x, m, k, n, iters=5, total_reps=None):
    rd = bytes_read(impl, k, n)
    stacked = stack_weights(weights, rd)
    before = _timing.total_launches()
    dt, calls = repeat_timer(fn, stacked, x, rd, iters=iters, total_reps=total_reps)
    us = dt * 1e6
    line = {
        "impl": impl, "m": m, "k": k, "n": n, "us": round(us, 2),
        "gbps_read": round(rd / (us * 1e-6) / 1e9, 1),
        "gbps_per_param": round(k * n / (us * 1e-6) / 1e9, 1),
        "launches": _timing.total_launches() - before, "calls": calls,
    }
    print(json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------- stream SOL


def stream_bytes(packed, absmax, tk=512, tn=256, *, plain: bool = False):
    """The read-rate probe (K13): (1, n), the sum over k tiles j of f32(column
    sums of tile j's bytes) + absmax[j tk/64]; the kernel reads every byte of
    the tiles."""
    return lab_kernels.stream_bytes(packed, absmax, tk, tn, plain=plain)


def _int4_matmul(x, w):
    """The reference's int4 impl: x @ codes in [-8, 8) (held in int8 here:
    PyTorch has no int4 tensor) with f32 sums, times the column scale, cast to
    x's dtype once."""
    return (torch.matmul(x.float(), w["q"].float()) * w["s"]).to(x.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("impls", nargs="*", default=None)
    ap.add_argument("--shapes", default="qkv,proj,fc,down")
    ap.add_argument("--m", default="1")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tk", type=int, default=512)
    ap.add_argument("--tn", type=int, default=256)
    ap.add_argument("--reps", type=int, default=TOTAL_REPS,
                    help="calls a timing run makes: sweeps of the stacked copies")
    args = ap.parse_args(argv)
    _timing.require_cuda()
    impls = args.impls or ["bf16", "int8", "nf4_xla", "nf4_v0", "stream"]
    shapes = [SHAPES[s] for s in args.shapes.split(",")]
    ms_list = [int(x) for x in args.m.split(",")]

    calibrate()
    for (k, n) in shapes:
        gen = torch.Generator(device="cuda").manual_seed(k * n)
        p4 = make_q4(k, n, gen)
        w_bf16 = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        q8 = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        scale8 = torch.full((n,), 2e-3, device="cuda")
        for m in ms_list:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            for impl in impls:
                try:
                    if impl == "bf16":
                        f = lambda x, w: x @ w["w"]
                        weights = {"w": w_bf16}
                    elif impl == "int8":
                        f = lambda x, w: quant.int8_matmul(x, w["q8"], w["scale8"])
                        weights = {"q8": q8, "scale8": scale8}
                    elif impl == "int4":
                        q4lin = torch.randint(-8, 8, (k, n), generator=gen, device="cuda",
                                              dtype=torch.int8)
                        f = _int4_matmul
                        weights = {"q": q4lin, "s": scale8}
                    elif impl == "nf4_xla":
                        f = lambda x, w: torch.matmul(x, quant.dequantize(w, x.dtype))
                        weights = p4
                    elif impl == "nf4_v0":
                        if not quant_kernels.pallas_eligible(p4, k, n):
                            print(json.dumps({"impl": impl, "m": m, "k": k, "n": n,
                                              "skip": "ineligible"}), flush=True)
                            continue
                        f = lambda x, w: quant_kernels.quantized_matmul_pallas(x, w)
                        weights = p4
                    elif impl == "stream":
                        f = lambda x, w: stream_bytes(
                            w["q4"], w["absmax"], tk=args.tk, tn=args.tn
                        ) + x.float().sum() * 1e-30
                        weights = p4
                    elif impl in ("v12", "v12b"):
                        tk = args.tk
                        f = V.get_v12(k, n, tk=tk, tn=1024, bf16=impl == "v12b")
                        weights = {
                            "pw": torch.randint(-2**31, 2**31 - 1,
                                                (k // tk, n // 1024, tk, 128), generator=gen,
                                                device="cuda", dtype=torch.int32),
                            "u": torch.ones((k,), device="cuda"),
                            "v": torch.full((n,), 0.02, device="cuda"),
                        }
                    elif impl == "v9t":
                        tk = args.tk
                        f = V.get_v9t(k, n, tk=tk, tn=1024)
                        weights = {
                            "pw": torch.randint(-2**31, 2**31 - 1,
                                                (k // tk, n // 1024, tk, 128), generator=gen,
                                                device="cuda", dtype=torch.int32),
                            "s": torch.rand((k // tk, n // 1024, tk // 64, 1024), generator=gen,
                                            device="cuda") * 0.02 + 0.01,
                        }
                    elif impl in ("v8", "v9", "v10", "v11"):
                        tn = args.tn if args.tn >= 1024 else 1024
                        if impl == "v8":
                            f = V.get_v8(k, n, tk=args.tk, tn=tn)
                        elif impl == "v9":
                            f = V.get_v9(k, n, tk=args.tk, tn=tn)
                        else:
                            f = V.get_v10(impl, k, n, tk=args.tk, tn=tn)
                        weights = {
                            "pw": torch.randint(0, 2**31 - 1, (k, n // 8), generator=gen,
                                                device="cuda", dtype=torch.int32),
                            "s": p4["absmax"],
                        }
                    elif impl.startswith("v"):
                        if impl in ("v6", "v7"):
                            f = V.get_int4(impl, k, n, tk=args.tk, tn=args.tn)
                        else:
                            f = V.get(impl, k, n, tk=args.tk, tn=args.tn)
                        weights = p4
                    else:
                        raise ValueError(impl)
                    run_one(impl, f, weights, x, m, k, n, iters=args.iters,
                            total_reps=args.reps)
                except Exception as e:  # noqa: BLE001 -- one line per impl, as the reference
                    print(json.dumps({"impl": impl, "m": m, "k": k, "n": n,
                                      "error": str(e)[:200]}), flush=True)
        del p4, w_bf16, q8


if __name__ == "__main__":
    main()
