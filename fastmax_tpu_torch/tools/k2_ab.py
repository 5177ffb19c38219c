"""Time K2's routes on the same inputs, in turns, on one card.

Variants: the one-block kernel (nsplit 1), the split route at each ``--chunks``
length, and, for each ``--const NAME=VALUE``, the split route at each of those
lengths built from a copy of ``csrc/`` in which the split kernels' constant
NAME is set to VALUE (``kUsePdl=false``: the value pass and the combine
launched as ordinary kernels instead of programmatic dependents of the pass
before; ``kSlots=3``: three items' operands in flight a block); and, with
``--bare``, the split route at each length built from a copy whose score and
value loops are emptied: the copies, barriers, stats and launches stay, the
arithmetic on the codes goes, so its time is the floor the data movement sets
(its output is wrong and is not checked). Every other variant is held against
``int8_decode_attention_plain`` at
chip_smoke.py's gates, then timed in rounds A B ... B A: device ms a call in a
CUDA graph, the cache cold (the layers of chip_smoke.ATTN_TIMED rotated), bf16
q, Hq = G = 32, D = 128, at chip_smoke.ATTN_TIMED's shapes (batch 1 at pos 191
and 1023, S = 1024; 8 slots at pos 3000, S = 4096). Prints each variant's
median beside the bound, with the card's name and power limit, and, with
``--profile``, the device time of each of the route's kernels (torch.profiler,
eager calls). ``decode_splits``' rule is read from this output.

    python -m fastmax_tpu_torch.tools.k2_ab --chunks 64,128,256,512 --const kUsePdl=false
    python -m fastmax_tpu_torch.tools.k2_ab --chunks 256 --bare

Needs an NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import re
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

from ..kernels import build
from ..ops import decode_attention as da

REPO = Path(__file__).resolve().parents[2]
BARE = "bare"
# the score and value loops over a tile's positions, and their emptied form
LOOPS = (("for (int jb = t0; jb < min(it.rows, t0 + kTile); jb += kRpp) {",
          "for (int jb = t0; jb < min(it.rows, t0 + kTile) && it.rows < 0; jb += kRpp) {"),
         ("for (int j = t0 + rg; j < min(rows, t0 + kTile); j += kRpp) {",
          "for (int j = t0 + rg; j < min(rows, t0 + kTile) && rows < 0; j += kRpp) {"))


def variant_kernels(specs, bare: bool, tmp: Path) -> dict:
    """{"NAME=VALUE": K2 built from a copy of ``csrc/`` with that constant set,
    and BARE: one with its score and value loops emptied}."""
    real = build.KERNELS["int8_decode_attention"]
    kernels = {}
    for i, spec in enumerate(specs + ([BARE] if bare else [])):
        src = tmp / f"variant{i}"
        shutil.copytree(build.CSRC_DIR, src)
        text = (src / real.source.name).read_text()
        if spec == BARE:
            for written, emptied in LOOPS:
                if text.count(written) != 1:
                    raise RuntimeError(f"{written!r} is not in {real.source.name} once")
                text = text.replace(written, emptied)
        else:
            name, _, value = spec.partition("=")
            pattern = re.compile(rf"(constexpr \w+ {re.escape(name)} = )[^;]+;")
            text, found = pattern.subn(rf"\g<1>{value};", text)
            if found != 1:
                raise RuntimeError(f"{name} is set {found} times in {real.source.name}, not once")
        (src / real.source.name).write_text(text)
        kernels[spec] = build.Kernel(real.name, str(src / real.source.name), real.replaces,
                                     real.entry, real.argtypes)
    jobs = [(k, k._start_build()) for k in kernels.values()]
    for k, job in jobs:
        k._finish_build(job)
    return kernels


def profile_kernels(torch, fn, calls: int, label: str, card: str) -> None:
    """Mean device us a call of each kernel that ``calls`` eager calls of fn launch
    (a programmatic dependent's time includes its wait for the kernel before it),
    and of the union of their intervals."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    print(f"  profile {label}: {chip_smoke.union_us(spans) / calls:8.2f} us a call while any "
          f"kernel of it ran   [{card}]", flush=True)
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            print(f"  profile {label}: {dev_us / calls:8.2f} us a call  x{ev.count / calls:.0f}  "
                  f"{ev.key[:70]}   [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="64,128,256,512", help="split chunk lengths")
    ap.add_argument("--const", action="append", default=[],
                    help="NAME=VALUE: a copy of the source with that constant set")
    ap.add_argument("--bare", action="store_true",
                    help="also the split with its score and value loops emptied")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--profile", action="store_true",
                    help="device time of each kernel of decode_splits' route")
    args = ap.parse_args(argv)
    build._require_cuda()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    real = build.KERNELS["int8_decode_attention"]
    tmp = Path(tempfile.mkdtemp())
    try:
        kernels = {"this": real, **variant_kernels(args.const, args.bare, tmp)}
        for label, b, s, pos, n_layers in chip_smoke.ATTN_TIMED:
            kc, vc, ks, vs = chip_smoke.attn_inputs(torch, gen, n_layers, b, 32, s, 128)
            q = torch.randn((b, 32, 1, 128), generator=gen, device="cuda").to(torch.bfloat16)
            posv = torch.full((b,), pos, dtype=torch.int32, device="cuda")
            rule = da.decode_splits(b * 32, s, 1, 128)
            variants = {"one-block": ("this", 1)}
            for c in (int(v) for v in args.chunks.split(",") if v):
                if c <= da.MAX_CHUNK:
                    for kern in kernels:
                        variants[f"chunk {c}" + ("" if kern == "this" else f" {kern}")] = (
                            kern, -(-s // c))
            it = iter(range(10**9))

            def call(split, layer=None):
                return da.int8_decode_attention_stacked(
                    q, kc, vc, ks, vs, next(it) % n_layers if layer is None else layer, posv,
                    scale=128 ** -0.5, split=split)
            ref = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, posv, scale=128 ** -0.5,
                                                   plain=True)
            times = {name: [] for name in variants}
            order = list(variants)
            for rnd in range(args.rounds):
                for name in (order if rnd % 2 == 0 else order[::-1]):
                    kern, split = variants[name]
                    build.KERNELS["int8_decode_attention"] = kernels[kern]
                    if rnd == 0 and kern != BARE:
                        chip_smoke.attn_held(torch, f"{name} {label} pos={pos}", call(split, 0),
                                             ref, torch.bfloat16)
                    times[name].append(chip_smoke.graph_ms(lambda: call(split),
                                                           calls=2 * n_layers))
            bnd = chip_smoke.attn_bound(b, 32, 32, 128, pos)
            for name, ts in times.items():
                kern, split = variants[name]
                med = statistics.median(ts)
                mark = "  <- decode_splits" if kern == "this" and split == rule else ""
                print(f"K2 {name} (nsplit {split}), {label} B={b} S={s} pos={pos}: median "
                      f"{med * 1e3:.2f} us over {len(ts)} rounds "
                      f"({', '.join(f'{t * 1e3:.2f}' for t in ts)}), {bnd['bound_ms'] / med:.3f} "
                      f"of the {bnd['bound_ms'] * 1e3:.2f} us bound{mark}   [{card}]", flush=True)
            if args.profile:
                build.KERNELS["int8_decode_attention"] = real
                profile_kernels(torch, lambda: call(rule), 2 * n_layers, f"{label} pos={pos}",
                                card)
            del kc, vc, ks, vs
    finally:
        build.KERNELS["int8_decode_attention"] = real
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
