"""Time K8 built from several copies of ``csrc/`` on the same inputs, in turns.

Variants: this checkout's ``csrc/`` ("this"); this build on the route K8 took
before its tensor-core path ("earlier route", chip_smoke.earlier_route: the gemv
up to m = 8, the FMA tile above); each ``--other NAME=DIR`` (a ``csrc/`` directory, for example of a
parent commit unpacked beside the checkout); and, with ``--table-copies
1,2,4``, copies of this ``csrc/`` whose tensor-core kernel keeps its byte table
in that many copies (its ``kTabCopies``; fewer copies than 8 let the lanes of a
quarter warp meet in a shared-memory bank, so the difference is the cost of
bank conflicts). Every variant is built, held against ``nf4_matmul_plain`` at
chip_smoke.py's gates, then timed in rounds A B ... B A: device ms a call in a
CUDA graph, weights cold (enough copies to exceed the 50 MB L2), summed over
Llama-2-7B's qkv, attn.proj and fc_12, at each ``--m``, f32 and bf16 x. Prints
each variant's median with the card's name and power limit.

    python -m fastmax_tpu_torch.tools.k8_ab --table-copies 1,2,4 --m 8,16,64
    python -m fastmax_tpu_torch.tools.k8_ab --other parent=out/parent/fastmax_tpu_torch/csrc

Needs an NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import re
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from ..kernels import build
from ..ops import quant
from ..ops import quant_kernels as qk

REPO = Path(__file__).resolve().parents[2]
COPIES = re.compile(r"(constexpr int kTabCopies = )\d+;")
LINEARS = ((4096, 12288), (4096, 4096), (4096, 22016))  # qkv, attn.proj, fc_12
EARLIER = "earlier route"


def variants(args, tmp: Path) -> dict:
    """{name: Kernel} built from each variant's copy of K8's source ("earlier
    route" is this build's)."""
    real = build.KERNELS["nf4_matmul"]
    dirs = {"this": build.CSRC_DIR}
    for spec in args.other:
        name, _, path = spec.partition("=")
        dirs[name] = Path(path).resolve()
    for copies in (int(c) for c in args.table_copies.split(",") if c):
        src = tmp / f"copies{copies}"
        shutil.copytree(build.CSRC_DIR, src)
        text, found = COPIES.subn(rf"\g<1>{copies};", (src / real.source.name).read_text())
        if found != 1:
            raise RuntimeError(f"kTabCopies is set {found} times in {real.source.name}, not once")
        (src / real.source.name).write_text(text)
        dirs[f"table copies={copies}"] = src
    kernels = {name: build.Kernel(real.name, str(d / real.source.name), real.replaces,
                                  real.entry, real.argtypes) for name, d in dirs.items()}
    jobs = [(k, k._start_build()) for k in kernels.values()]
    for k, job in jobs:
        k._finish_build(job)
    kernels[EARLIER] = kernels["this"]
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], help="NAME=DIR of a csrc copy")
    ap.add_argument("--table-copies", default="", help="copies of the tc kernel's byte table")
    ap.add_argument("--m", default="8", help="rows of x, comma-separated")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    build._require_cuda()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tmp = Path(tempfile.mkdtemp())
    real = build.KERNELS["nf4_matmul"]
    try:
        kernels = variants(args, tmp)
        weights = []
        for k, n in LINEARS:
            p = quant.quantize_4bit(torch.randn((k, n), generator=gen, device="cuda") * 0.05)
            nbytes = k * n // 2 + k // 64 * n * 4
            weights.append([p] + [{key: v.clone() for key, v in p.items()}
                                  for _ in range(max(1, math.ceil(160e6 / nbytes)) - 1)])
        for m in (int(v) for v in args.m.split(",")):
            for dt in (torch.float32, torch.bfloat16):
                xs = [(torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(dt)
                      for k, _ in LINEARS]
                times = {name: [] for name in kernels}
                order = list(kernels)
                for rnd in range(args.rounds):
                    for name in (order if rnd % 2 == 0 else order[::-1]):
                        build.KERNELS["nf4_matmul"] = kernels[name]
                        route = (chip_smoke.earlier_route(qk, "K8") if name == EARLIER
                                 else contextlib.nullcontext())
                        with route:
                            if rnd == 0:
                                for x, copies in zip(xs, weights):
                                    got = qk.quantized_matmul_pallas(x, copies[0])
                                    ref = qk.quantized_matmul_pallas(x, copies[0], plain=True)
                                    rtol = (chip_smoke.NF4_RTOL if dt == torch.float32
                                            else chip_smoke.INT4_BF16_RTOL)
                                    chip_smoke.held(torch, f"K8 {name} m={m} {dt}", got, ref,
                                                    chip_smoke.NF4_ATOL, rtol)
                            total = 0.0
                            for x, copies in zip(xs, weights):
                                it = iter(range(10**9))
                                total += chip_smoke.graph_ms(
                                    lambda: qk.quantized_matmul_pallas(
                                        x, copies[next(it) % len(copies)]),
                                    calls=2 * len(copies))
                            times[name].append(total)
                with chip_smoke.earlier_route(qk, "K8"):
                    earlier_path = qk.nf4_path(m)
                for name, ts in times.items():
                    path = earlier_path if name == EARLIER else qk.nf4_path(m)
                    print(f"K8 {name} ({path}), qkv + attn.proj + fc_12, m={m} "
                          f"{str(dt)[6:]}: median {statistics.median(ts) * 1e3:.1f} us over "
                          f"{len(ts)} rounds ({', '.join(f'{t * 1e3:.1f}' for t in ts)})   "
                          f"[{card}]", flush=True)
    finally:
        build.KERNELS["nf4_matmul"] = real
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
