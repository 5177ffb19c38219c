"""Time the reversible fastmax scan at several head-group counts, in turns.

Masked fastmax at head sizes above 64 (``ops/fastmax.py``) runs its float32
scan over groups of heads, as many as ``_auto_head_groups`` gives for
``FASTMAX_TPU_HEADGROUP_LIMIT`` bytes (64 MiB: 8 groups of 4 heads at the
Llama-2-7B finetune shape). Each count of ``--groups`` runs ``_masked_grouped``
on the same inputs (q, k at std sqrt(8), v and the cotangent at std 1, as
chip_smoke.py's op check draws them), is held against the same scan in float64
at ``chip_smoke.LINEAR_F32_REL``, then timed in rounds A B ... B A: the
forward, and the forward + backward, by CUDA events around eager calls (host
time included: a call issues thousands of kernels). Prints each count's
medians, its peak memory and its rate against the f32 data-sheet peak, with
the card's name and power limit; ``--profile`` adds each count's device time,
kernel launches and top kernels of one forward + backward.

    python -m fastmax_tpu_torch.tools.linear_scan_ab --groups 8,4,2,1 --profile

Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import math
import statistics
import sys
from pathlib import Path

import torch

from ..kernels import build
from ..ops import fastmax as fm

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", default="8,4,2,1", help="head-group counts, comma-separated")
    ap.add_argument("--shape", default="2,32,2048,128", help="B,H,N,D")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    build._require_cuda()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    shape = tuple(int(x) for x in args.shape.split(","))
    b, h, n, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = chip_smoke.fastmax_qkv(torch, gen, shape, 2, torch.float32)
    z, chunk = 8.0 * math.sqrt(d), fm._auto_chunk(fm.DEFAULT_CHUNK, n)
    counts = [int(x) for x in args.groups.split(",")]

    def fwd(groups):
        with torch.no_grad():
            fm._masked_grouped(q, k, v, z, 2, chunk, groups)

    def fwd_bwd(groups, dtype=torch.float32):
        ts = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
        o = fm._masked_grouped(*ts, z, 2, chunk, groups)
        o.backward(do.to(dtype))
        return [o.detach()] + [t.grad for t in ts]

    ref = fwd_bwd(None, torch.float64)
    for groups in counts:
        for name, got, r in zip(("o", "dq", "dk", "dv"), fwd_bwd(groups), ref):
            chip_smoke.linear_rel(torch, f"{groups} head groups {name} vs float64", got, r,
                                  chip_smoke.LINEAR_F32_REL["fwd" if name == "o" else "grad"])
    del ref
    times = {g: {"fwd": [], "fwd_bwd": []} for g in counts}
    peak = dict.fromkeys(counts, 0)
    for rnd in range(args.rounds):
        for groups in (counts if rnd % 2 == 0 else counts[::-1]):
            torch.cuda.reset_peak_memory_stats()
            times[groups]["fwd"].append(chip_smoke.time_ms(lambda: fwd(groups), 1, warmup=1))
            times[groups]["fwd_bwd"].append(chip_smoke.time_ms(lambda: fwd_bwd(groups), 1,
                                                               warmup=1))
            peak[groups] = max(peak[groups], torch.cuda.max_memory_allocated())
    flops = chip_smoke.linear_scan_flops(b * h, n, d, chunk, backward=True)
    for groups in counts:
        f_ms, fb_ms = (statistics.median(times[groups][key]) for key in ("fwd", "fwd_bwd"))
        rate = flops / fb_ms * 1e3
        print(f"scan B={b} H={h} N={n} D={d} chunk {chunk}, {groups} head groups: forward "
              f"{f_ms:.1f} ms, forward + backward {fb_ms:.1f} ms (rounds "
              f"{', '.join(f'{t:.1f}' for t in times[groups]['fwd_bwd'])}; {rate / 1e12:.1f} "
              f"TFLOP/s, {rate / chip_smoke.F32_FLOPS_PER_S:.3f} of the f32 data-sheet peak); "
              f"peak {peak[groups] / 1e9:.2f} GB   [{card}]", flush=True)
    if args.profile:
        for groups in counts:
            prof = chip_smoke.profile_device(torch, lambda: fwd_bwd(groups),
                                             f"one forward + backward, {groups} head groups",
                                             cpu=False)
            print(f"  {groups} head groups: {prof.get('kernel_launches', 0):.0f} kernels a "
                  f"forward + backward   [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
