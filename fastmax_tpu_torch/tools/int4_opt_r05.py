"""int4 decode-kernel lab, round 5 (counterpart of ``tools/int4_opt_r05.py``),
on the card.

The reference times differentially: a chained loop at two iteration counts
and the slope between them, so that the fixed dispatch cost cancels. Here
the two chains are CUDA graphs of ``iters_lo`` and ``iters_hi`` calls, and
the slope cancels the graph's own launch cost exactly. The weights are not
cycled, so a shape whose words fit in the card's 50 MB L2 reads from there.

Variants (the raw signed-nibble product on tiled words unless noted):
  ship       K9 raw (``int4_matmul_tiled``), packer default tk (= whole k)
  shipsem    the reference declares its grid ("parallel", "arbitrary"): the
             same function, K9 raw
  tk512/1024/2048  K9 raw on words packed at that k tile
  bf16dot    x and planes in bf16, f32 sums: K10 on the tensor cores
  onedot16   the same function with the 8 planes joined: K10
  m8         x repeated to 8 rows: K9 raw
  stream     the read-rate probe over the same words: K13 (``stream_ref``)

Each prints one JSON line: {variant, k, n, us, g_params_s, gbps_read,
launches, calls}, or {variant, k, n, error}.

  python -m fastmax_tpu_torch.tools.int4_opt_r05 [--variants ...] [--iters-hi 500] [--out f]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.quant import pack_int4_tiled
from ..ops.quant_kernels import int4_matmul_tiled
from . import _timing
from .lab_kernels import int4_tiled_bf16, stream_tiled

SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


def make_timer(iters_lo, iters_hi, reps=3):
    def _time(fn, x0):
        """Seconds a call, the slope between chains of iters_lo and iters_hi
        calls (each x picks up 1e-30 of the last output's sum); returns
        (seconds, calls made to fn)."""
        fn = _timing.Counted(fn)

        def run(n):
            def body():
                x = x0
                for _ in range(n):
                    y = fn(x)
                    x = x + (1e-30 * torch.sum(y)).to(x.dtype)

            graph = _timing.capture(body)
            best = _timing.replay_s(graph, reps)
            del graph
            return best

        t_lo, t_hi = run(iters_lo), run(iters_hi)
        return (t_hi - t_lo) / (iters_hi - iters_lo), fn.calls

    return _time


# ---------------------------------------------------------------- variants


def sem_matmul(x, pw_t, *, plain: bool = False):
    """B6's raw mode (K9): x (m, k_pad) f32 @ raw nibbles -> (m, n_pad) f32."""
    return int4_matmul_tiled(x.float(), pw_t, plain=plain)


def bf16_matmul(x, pw_t, onedot=False, *, plain: bool = False):
    """bf16(x) @ raw nibbles in bf16, f32 sums (K10); ``onedot`` joins the
    planes into one dot in the reference, the same function."""
    return int4_tiled_bf16(x, pw_t, plain=plain)


def stream_ref(pw_t, *, plain: bool = False):
    """The read-rate probe (K13): (1, n_pad), at column 1024 i + l (l < 128)
    the sum over j of f32(pw_t[j, i, 0, l]), zeros elsewhere; the kernel
    reads every word."""
    return stream_tiled(pw_t, plain=plain)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="ship,shipsem,tk512,tk1024,tk2048,bf16dot,onedot16,m8,stream")
    ap.add_argument("--iters-lo", type=int, default=100)
    ap.add_argument("--iters-hi", type=int, default=500)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _timing.require_cuda()

    timer = make_timer(args.iters_lo, args.iters_hi)
    variants = args.variants.split(",")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out_f = open(args.out, "a") if args.out else None

    for k, n in SHAPES_7B:
        codes = torch.randint(-8, 8, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        packs = {}

        def pw_for(tk=None):
            if tk not in packs:
                packs[tk] = pack_int4_tiled(codes, tk)
            return packs[tk]

        for v in variants:
            try:
                pw_t = pw_for(None)
                k_pad = pw_t.shape[0] * pw_t.shape[2]
                x = torch.randn((1, k_pad), generator=gen, device="cuda")
                if v == "ship":
                    fn, x0 = (lambda xx: int4_matmul_tiled(xx, pw_t)), x
                elif v == "shipsem":
                    fn, x0 = (lambda xx: sem_matmul(xx, pw_t)), x
                elif v.startswith("tk"):
                    tk = int(v[2:])
                    pw_v = pw_for(tk)
                    fn, x0 = (lambda xx: int4_matmul_tiled(xx, pw_v)), x
                elif v == "bf16dot":
                    fn, x0 = (lambda xx: bf16_matmul(xx, pw_t)), x
                elif v == "onedot16":
                    fn, x0 = (lambda xx: bf16_matmul(xx, pw_t, onedot=True)), x
                elif v == "m8":
                    x8 = x.repeat(8, 1)
                    fn, x0 = (lambda xx: int4_matmul_tiled(xx, pw_t)), x8
                elif v == "stream":
                    fn, x0 = (lambda xx: stream_ref(pw_t) + 0.0 * xx[:, :1]), x
                else:
                    continue
                before = _timing.total_launches()
                dt, calls = timer(fn, x0)
                params = k * n
                rec = {"variant": v, "k": k, "n": n,
                       "us": round(dt * 1e6, 2),
                       "g_params_s": round(params / dt / 1e9, 1),
                       "gbps_read": round(params * 0.5 / dt / 1e9, 1),
                       "launches": _timing.total_launches() - before, "calls": calls}
            except Exception as e:  # noqa: BLE001 -- one line per variant, as the reference
                rec = {"variant": v, "k": k, "n": n,
                       "error": f"{type(e).__name__}: {e}"[:200]}
            line = json.dumps(rec)
            print(line, flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
        del codes, packs
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
