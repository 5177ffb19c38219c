"""int4 decode-kernel lab, round 4 (counterpart of ``tools/int4_opt_r04.py``),
on the card.

Variants of the raw signed-nibble product x @ Q on tiled words (columns in
the packed order), timed at the Llama-2-7B decode shapes:

  base      K9's raw mode (``int4_matmul_tiled`` without scales), packer tk
  tk512/tk1024/tk2048  the same on words packed at that k tile
  onedot    the reference joins the 8 planes of a (tk, 1024) tile into one
            dot: the same function, K9 raw on words packed at tk = 1024
  m8        x padded to 8 rows, f32: K9 raw (its 64-row tile path above m = 4)
  m8bf16    x and planes in bf16, f32 sums: K10 on the tensor cores
  xla       plain PyTorch: 8 nibbles packed along k, unpacked to bf16 and
            multiplied (the reference leaves it to XLA)

Each prints one JSON line: {variant, k, n, us, g_params_s, gbps_read,
launches, calls} (``launches``: kernel launches the timer made, ``calls``:
its calls to the variant), or {variant, k, n, error}.

  python -m fastmax_tpu_torch.tools.int4_opt_r04 [--variants base,onedot,m8,xla] [--m 1]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.quant import pack_int4_tiled
from ..ops.quant_kernels import int4_matmul_tiled
from . import _timing
from .lab_kernels import int4_tiled_bf16

SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


def _time(fn, x0, iters=40):
    """Seconds a call: ``iters`` chained calls (each x picks up 1e-30 of the
    last output's sum, so no call can be skipped) captured in one CUDA graph,
    best of 3 replays. Returns (seconds, calls made to fn)."""
    fn = _timing.Counted(fn)
    state = {}

    def body():
        x = x0
        for _ in range(iters):
            y = fn(x)
            x = x + (1e-30 * torch.sum(y)).to(x.dtype)
        state["x"] = x

    graph = _timing.capture(body)
    dt = _timing.replay_s(graph, 3) / iters
    del graph
    return dt, fn.calls


# ---------------------------------------------------------------- variants


def onedot_matmul(x, pw_t, *, plain: bool = False):
    """x (m, k_pad) @ raw nibbles of tiled words -> (m, n_pad) f32, packed
    column order: B6's raw mode (K9)."""
    return int4_matmul_tiled(x.float(), pw_t, plain=plain)


def m8_matmul(x, pw_t, dtype=torch.float32, *, plain: bool = False):
    """The raw product at exactly m = 8, x and planes cast to ``dtype`` (f32:
    K9 raw; bf16: K10), f32 sums."""
    m, k_pad = x.shape
    if m != 8:
        raise ValueError(f"m8_matmul takes m = 8, not {m}")
    if dtype == torch.bfloat16:
        return int4_tiled_bf16(x, pw_t, plain=plain)
    if dtype != torch.float32:
        raise ValueError(f"dtype {dtype}")
    return int4_matmul_tiled(x.float(), pw_t, plain=plain)


def xla_unpack_matmul(x, w32):
    """w32 (k//8, n) int32, 8 nibbles packed ALONG K (nibble p of word r is
    row 8 r + p), unpacked to bf16; bf16 x; f32 sums (plain PyTorch: every
    product of two bf16 values is exact in f32)."""
    k8, n = w32.shape
    planes = []
    for p in range(8):
        nib = (w32 >> (4 * p)) & 0xF
        planes.append(nib - ((nib >> 3) << 4))
    w = torch.stack(planes, dim=1).reshape(k8 * 8, n).to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).float(), w.float())


def _pack_along_k(codes: torch.Tensor, k_pad: int) -> torch.Tensor:
    k, n = codes.shape
    full = torch.zeros((k_pad, n), dtype=torch.int64, device=codes.device)
    full[:k] = codes.long() & 0xF
    q = full.reshape(k_pad // 8, 8, n)
    words = torch.zeros((k_pad // 8, n), dtype=torch.int64, device=codes.device)
    for p in range(8):
        words |= q[:, p] << (4 * p)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="base,tk512,tk1024,tk2048,onedot,m8,m8bf16,xla")
    ap.add_argument("--m", type=int, default=1)
    args = ap.parse_args(argv)
    _timing.require_cuda()

    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, n in SHAPES_7B:
        codes = torch.randint(-8, 8, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        x1 = torch.randn((args.m, k), generator=gen, device="cuda")
        k_pad = k + (-k) % 512
        x1p = torch.nn.functional.pad(x1, (0, k_pad - k))
        x8 = torch.cat([x1p] + [torch.zeros_like(x1p)] * 7, dim=0)
        nbytes = k * n // 2

        for variant in args.variants.split(","):
            try:
                x0 = x1p
                if variant == "base":
                    pw = pack_int4_tiled(codes)
                    fn = lambda x, pw=pw: int4_matmul_tiled(x, pw)
                elif variant.startswith("tk"):
                    tk = int(variant[2:])
                    if k_pad % tk:
                        raise ValueError(f"k_pad {k_pad} % {tk}")
                    pw = pack_int4_tiled(codes, tile_k=tk)
                    fn = lambda x, pw=pw: int4_matmul_tiled(x, pw)
                elif variant == "onedot":
                    pw = pack_int4_tiled(codes, tile_k=1024)
                    fn = lambda x, pw=pw: onedot_matmul(x, pw)
                elif variant == "m8":
                    pw = pack_int4_tiled(codes)
                    fn = lambda x, pw=pw: m8_matmul(x, pw, dtype=torch.float32)
                    x0 = x8
                elif variant == "m8bf16":
                    pw = pack_int4_tiled(codes)
                    fn = lambda x, pw=pw: m8_matmul(x, pw, dtype=torch.bfloat16)
                    x0 = x8
                elif variant == "xla":
                    w32 = _pack_along_k(codes, k_pad)
                    fn = lambda x, w32=w32: xla_unpack_matmul(x, w32)
                else:
                    continue
                before = _timing.total_launches()
                dt, calls = _time(fn, x0)
                print(json.dumps({
                    "variant": variant, "k": k, "n": n,
                    "us": round(dt * 1e6, 2),
                    "g_params_s": round(k * n / dt / 1e9, 1),
                    "gbps_read": round(nbytes / dt / 1e9, 1),
                    "launches": _timing.total_launches() - before, "calls": calls,
                }), flush=True)
            except Exception as e:  # noqa: BLE001 -- one line per variant, as the reference
                print(json.dumps({
                    "variant": variant, "k": k, "n": n,
                    "error": f"{type(e).__name__}: {e}"[:200],
                }), flush=True)
        del codes


if __name__ == "__main__":
    main()
