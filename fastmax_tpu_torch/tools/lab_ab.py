"""Time K10 and K13 built from several copies of ``csrc/`` on the same inputs, in turns.

Variants: this checkout's ``csrc/`` ("this") and each ``--other NAME=DIR`` (a
``csrc/`` directory, for example of a parent commit unpacked beside the
checkout with ``git archive`` into ``out/``, which is gitignored and copied).
A source whose C entries launch a second kernel (K10's
``int4_tiled_bf16_reduce_kernel`` after a split-k scratch; K13's output kernels
after a zeroed checksum and a column-sum scratch) is called as those entries
were called. Every variant is held against the plain version first (K10 within
chip_smoke.py's phase 11 gate, K13 bit for bit), then timed in rounds A B ...
B A with chip_smoke.lab_time's measure: device ms a call in a CUDA graph,
weights cold (enough copies to exceed the 50 MB L2), on the same inputs. Cases:
K10 at Llama-2-7B's four decode linears (qkv, attn.proj, fc_12, mlp.proj)
summed, m = 1 and 8; K13 stream_ref and stream_bytes at the four linears
summed, and stream_ref over 512 MB. Prints each variant's median with the
card's name and power limit, and writes ``chiprun_out/lab_ab.json``.

    python -m fastmax_tpu_torch.tools.lab_ab --other parent=out/parent/fastmax_tpu_torch/csrc

Needs an NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import sys
from pathlib import Path

import torch

from ..kernels import build
from ..ops.quant import INT4_TILE_N
from ..ops.quant_kernels import _sm_count
from . import lab_kernels as lk

REPO = Path(__file__).resolve().parents[2]
NAMES = ("int4_tiled_bf16", "stream_probe")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the argument types of the two-launch entries
TWO_LAUNCH_ARGTYPES = {
    "int4_tiled_bf16": [_P, _I, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    "stream_probe": [_I, _P, ctypes.c_longlong, _I, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P],
}
TWO_LAUNCH_MARK = {"int4_tiled_bf16": "int4_tiled_bf16_reduce_kernel",
                   "stream_probe": "stream_ref_out_kernel"}


def variants(args) -> dict:
    """{variant: {kernel name: (Kernel, two_launch)}}, every library built."""
    dirs = {"this": build.CSRC_DIR}
    for spec in args.other:
        name, _, path = spec.partition("=")
        dirs[name] = Path(path).resolve()
    out = {}
    for vname, d in dirs.items():
        out[vname] = {}
        for name in NAMES:
            real = build.TOOL_KERNELS[name]
            two = TWO_LAUNCH_MARK[name] in (d / real.source.name).read_text()
            out[vname][name] = (build.Kernel(real.name, str(d / real.source.name), real.replaces,
                                             real.entry,
                                             TWO_LAUNCH_ARGTYPES[name] if two else real.argtypes),
                                two)
    distinct = {k.library_path(): k for v in out.values() for k, _ in v.values()}
    jobs = [(k, k._start_build()) for k in distinct.values()]  # one build a distinct source
    for k, job in jobs:
        k._finish_build(job)
    return out


def two_launch_call(kernel, variant, x, w):
    """The two-launch entries, called with the scratch they take."""
    dev = x.device
    if variant == "raw":
        pw = w["pw"]
        gk, gn, tk, _ = pw.shape
        m, k = x.shape
        xb = x.to(torch.bfloat16).contiguous()
        splits, per = lk._splits(gn * 8 * math.ceil(m / 8), k, 64, _sm_count(dev.index or 0))
        y = torch.empty((m, gn * INT4_TILE_N), dtype=torch.float32, device=dev)
        part = torch.empty((splits, m, gn * INT4_TILE_N), dtype=torch.float32, device=dev)
        kernel.launch(xb.data_ptr(), m, pw.data_ptr(), gk, gn, tk, y.data_ptr(), part.data_ptr(),
                      splits, per * 64)
        return y
    checksum = torch.zeros(1, dtype=torch.int32, device=dev)
    if variant == "stream_ref":
        pw = w["pw"]
        gk, gn, tk, _ = pw.shape
        out = torch.empty((1, gn * INT4_TILE_N), dtype=torch.float32, device=dev)
        kernel.launch(0, pw.data_ptr(), pw.numel(), tk, gn, gk, None, tk, 0, out.data_ptr(),
                      out.shape[1], None, checksum.data_ptr())
        return out
    q4, absmax = w["q4"], w["absmax"]
    k2, n = q4.shape
    tiles = 2 * k2 // 512
    out = torch.empty((1, n), dtype=torch.float32, device=dev)
    colsum = torch.empty((tiles, n), dtype=torch.int32, device=dev)
    kernel.launch(1, q4.data_ptr(), 0, k2, n, tiles, absmax.data_ptr(), 512, 256, out.data_ptr(),
                  n, colsum.data_ptr(), checksum.data_ptr())
    return out


CASES = (("K10", "raw", 1), ("K10", "raw", 8), ("K13", "stream_ref", 1),
         ("K13", "stream_bytes", 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], help="NAME=DIR of a csrc copy")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    build._require_cuda()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = {name: build.TOOL_KERNELS[name] for name in NAMES}
    report = {"card": card, "cases": []}
    try:
        kern = variants(args)
        order = list(kern)
        shapes = [(k, n) for _, k, n in chip_smoke.LLAMA7B_LINEARS]
        cases = [(short, v, m, shapes) for short, v, m in CASES] + [
            ("K13", "stream_ref", 1, [(16384, 65536)])]
        for short, v, m, case_shapes in cases:
            name = chip_smoke.LAB_KERNEL[short]
            setups = []
            for k, n in case_shapes:
                s = chip_smoke.lab_setup(torch, gen, short, v, k, n, m)
                s["copies"] = [s["w"]] + [{key: t.clone() for key, t in s["w"].items()}
                                          for _ in range(max(1, math.ceil(160e6 / s["bytes_w"]))
                                                         - 1)]
                setups.append(s)

            def call(vname, s, w):
                kernel, two = kern[vname][name]
                if two:
                    return two_launch_call(kernel, v, s["x"], w)
                build.TOOL_KERNELS[name] = kernel
                return s["call"](s["x"], w, False)

            for vname in order:  # each variant against the plain version first
                for s, (k, n) in zip(setups, case_shapes):
                    got, ref = call(vname, s, s["w"]), s["call"](s["x"], s["w"], True)
                    torch.cuda.synchronize()
                    what = f"{short} {v} {vname} k={k} n={n} m={m}"
                    if s["exact"]:
                        if not torch.equal(got, ref):
                            raise AssertionError(f"{what}: not bit for bit")
                    else:
                        chip_smoke.held(torch, what, got, ref,
                                        chip_smoke.LAB_ATOL * float(ref.abs().max()),
                                        chip_smoke.LAB_RTOL)
            times = {vname: [] for vname in order}
            for rnd in range(args.rounds):
                for vname in (order if rnd % 2 == 0 else order[::-1]):
                    total = 0.0
                    for s in setups:
                        it = iter(range(10**9))
                        total += chip_smoke.graph_ms(
                            lambda s=s, it=it: call(vname, s,
                                                    s["copies"][next(it) % len(s["copies"])]),
                            calls=2 * len(s["copies"]))
                    times[vname].append(total)
            bound_ms = sum(chip_smoke.bound(s["bytes_w"] + s["io"], s["flops"], s["bf16"])[
                "bound_ms"] for s in setups)
            where = "512 MB" if case_shapes[0] == (16384, 65536) else "the four 7B linears"
            for vname, ts in times.items():
                med = statistics.median(ts)
                print(f"{short} {v} {where} m={m} [{vname}]: median {med * 1e3:.1f} us over "
                      f"{len(ts)} rounds ({', '.join(f'{t * 1e3:.1f}' for t in ts)}); bound "
                      f"{bound_ms * 1e3:.1f} us, {bound_ms / med:.3f} of it   [{card}]",
                      flush=True)
            report["cases"].append({"kernel": short, "variant": v, "m": m, "where": where,
                                    "bound_ms": bound_ms, "times_ms": times})
            del setups
            torch.cuda.empty_cache()
    finally:
        build.TOOL_KERNELS.update(saved)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "lab_ab.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
