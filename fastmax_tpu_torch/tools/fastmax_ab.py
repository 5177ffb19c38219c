"""Time K4 or K5 built from several copies of ``csrc/`` on the same inputs, in turns.

Variants: this checkout's ``csrc/`` ("this"); each ``--other NAME=DIR`` (a
``csrc/`` directory, for example of a parent commit unpacked beside the
checkout); and, with ``--lead-tiles 0,1,2``, copies of this ``csrc/`` whose
``fastmax_fwd.cu`` gives CTA 0 of a head that many pair tiles in both types (its
``kLeadTiles``). Every variant is built, held against the plain walk at
chip_smoke.py's gates, then timed in rounds A B ... B A (device ms per call in
a CUDA graph over four cold input sets), at B=4 H=8 D=64 p=2 on the path
``fwd_path``/``bwd_path`` picks, f32 and bf16. Prints each variant's median
with the card's name and power limit.

    python -m fastmax_tpu_torch.tools.fastmax_ab --kernel fastmax_bwd --other parent=DIR
    python -m fastmax_tpu_torch.tools.fastmax_ab --kernel fastmax_fwd --lead-tiles 0,1,2,3

Needs an NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import math
import re
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from ..kernels import build
from ..ops import fastmax_kernels as fk

REPO = Path(__file__).resolve().parents[2]
LEAD = re.compile(r"(constexpr int kLeadTiles[^=]*= )\d+;")


def variants(args, tmp: Path) -> dict:
    """{name: Kernel} built from each variant's copy of the kernel's source."""
    real = build.KERNELS[args.kernel]
    dirs = {"this": build.CSRC_DIR}
    for spec in args.other:
        name, _, path = spec.partition("=")
        dirs[name] = Path(path).resolve()
    for lead in (int(x) for x in args.lead_tiles.split(",") if x):
        src = tmp / f"lead{lead}"
        shutil.copytree(build.CSRC_DIR, src)
        text = (src / "fastmax_fwd.cu").read_text()
        text, found = LEAD.subn(rf"\g<1>{lead};", text)
        if found != 2:
            raise RuntimeError(f"kLeadTiles is set {found} times in fastmax_fwd.cu, not twice")
        (src / "fastmax_fwd.cu").write_text(text)
        dirs[f"lead_tiles={lead}"] = src
    kernels = {name: build.Kernel(real.name, str(d / real.source.name), real.replaces,
                                  real.entry, real.argtypes) for name, d in dirs.items()}
    jobs = [(k, k._start_build()) for k in kernels.values()]
    for k, job in jobs:
        k._finish_build(job)
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("fastmax_fwd", "fastmax_bwd"), required=True)
    ap.add_argument("--other", action="append", default=[], help="NAME=DIR of a csrc copy")
    ap.add_argument("--lead-tiles", default="", help="K4 variants: CTA 0's pair tiles")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    build._require_cuda()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, n, d, p, chunk = 32, args.n, 64, 2, args.chunk
    z = 8.0 * math.sqrt(d)
    tmp = Path(tempfile.mkdtemp())
    real = build.KERNELS[args.kernel]
    try:
        kernels = variants(args, tmp)
        for dt in (torch.float32, torch.bfloat16):
            sets = [chip_smoke.fastmax_qkv(torch, gen, (bh, n, d), p, dt) for _ in range(4)]
            fwd_out = [fk.fastmax_fwd_plain(q, k, v, p, z, chunk) for q, k, v, _ in sets]
            it = iter(range(10**9))

            def call():
                i = next(it) % len(sets)
                q, k, v, do = sets[i]
                if args.kernel == "fastmax_fwd":
                    return fk._fwd_launch(q, k, v, p, z, chunk, train=True)
                return fk._bwd_launch(q, k, v, do, *fwd_out[i], p, z, chunk)

            q, k, v, do = sets[0]
            ref = (fwd_out[0][:2] + tuple(fwd_out[0][2]) if args.kernel == "fastmax_fwd" else
                   fk.fastmax_bwd_plain(q, k, v, do, *fwd_out[0], p, z, chunk))
            kind = "fwd" if args.kernel == "fastmax_fwd" else "grad"
            times = {name: [] for name in kernels}
            order = list(kernels)
            for rnd in range(args.rounds):
                for name in (order if rnd % 2 == 0 else order[::-1]):
                    build.KERNELS[args.kernel] = kernels[name]
                    if rnd == 0:
                        it = iter(range(10**9))
                        out = call()
                        got = out[:2] + tuple(out[2]) if kind == "fwd" else out
                        for a, b in zip(got, ref):
                            chip_smoke.fastmax_close(torch, f"{args.kernel} {name}", a, b, kind,
                                                     dt)
                    times[name].append(chip_smoke.graph_ms(call, calls=8))
            path = (fk.fwd_path if kind == "fwd" else fk.bwd_path)(p, d)
            for name, ts in times.items():
                print(f"{args.kernel} ({path}) {name}, B=4 H=8 N={n} D=64 chunk "
                      f"{chunk} {str(dt)[6:]}: median {statistics.median(ts) * 1e3:.1f} us over "
                      f"{len(ts)} rounds ({', '.join(f'{x * 1e3:.1f}' for x in ts)})   [{card}]",
                      flush=True)
    finally:
        build.KERNELS[args.kernel] = real
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
