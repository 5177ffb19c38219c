"""Time K6 and K7 built from several copies of ``csrc/`` on the same inputs, in turns.

Variants: this checkout's ``csrc/`` ("this") and each ``--other NAME=DIR`` (a
``csrc/`` directory, for example of a parent commit unpacked beside the
checkout). Every variant's K6 (``flash_train_fwd.cu``) and K7
(``flash_train_bwd.cu``) is built, held against the plain versions at
chip_smoke.py's gates (``flash_train_case``, the fused entry, bf16), then timed
in rounds A B ... B A at ``--shape`` (default Gemma-7B's finetune shape, B=1
H=16 T=1024 D=256): device us a call in a CUDA graph over four cold input sets,
as ``chip_smoke.flash_train_times`` times them, beside the call's bound. With
``--qlora-step``, also one Gemma-7B QLoRA micro-batch (NF4 base, LoRA r 8 on
query, value and the MLP, T 1024, bf16, phase 15's) with each variant's K6/K7:
host ms in the same turns, then one profile a variant (device ms, K6 and K7).
Prints each variant's registers and spills a kernel function (the build's
``-Xptxas -v``) and its medians, with the card's name and power limit.

    python -m fastmax_tpu_torch.tools.flash_train_ab --other parent=out/parent/fastmax_tpu_torch/csrc
    python -m fastmax_tpu_torch.tools.flash_train_ab --other parent=DIR --shape 2,32,2048,128

Needs an NVIDIA GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
import time
from pathlib import Path

import torch

from ..kernels import build
from ..ops import flash_attention as fa

REPO = Path(__file__).resolve().parents[2]
NAMES = ("flash_train_fwd", "flash_train_bwd")
N_SETS = 4
ENTRY = re.compile(r"Compiling entry function '.*?(flash_train_[a-z_]*kernel)I(\w*?)Li(\d+)E")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], help="NAME=DIR of a csrc copy")
    ap.add_argument("--shape", default="1,16,1024,256", help="B,H,T,D")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--qlora-step", action="store_true",
                    help="also time a Gemma-7B QLoRA micro-batch with each variant")
    args = ap.parse_args(argv)
    args.shape = tuple(int(x) for x in args.shape.split(","))
    if len(args.shape) != 4:
        ap.error(f"--shape takes B,H,T,D, not {args.shape}")
    for spec in args.other:
        if "=" not in spec:
            ap.error(f"--other takes NAME=DIR, not {spec!r}")
    return args


def variants(args) -> dict:
    """{name: {kernel name: Kernel}} built from each variant's ``csrc/``, in parallel."""
    dirs = {"this": build.CSRC_DIR}
    for spec in args.other:
        name, _, path = spec.partition("=")
        dirs[name] = Path(path).resolve()
    out = {}
    for name, d in dirs.items():
        out[name] = {}
        for kname in NAMES:
            real = build.KERNELS[kname]
            out[name][kname] = build.Kernel(real.name, str(d / real.source.name), real.replaces,
                                            real.entry, real.argtypes)
    jobs = [(k, k._start_build()) for ks in out.values() for k in ks.values()]
    for k, job in jobs:
        k._finish_build(job)
    return out


def ptxas_lines(log: str) -> list:
    """"function<type, D>: N registers, S bytes spilled" for each kernel function of a
    build log of ``-Xptxas -v``."""
    out, name = [], None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            fn, ty, d = m.groups()
            name = f"{fn}<{'bf16, ' if 'bfloat16' in ty else 'f32, ' if ty == 'f' else ''}{d}>"
            stores = "?"
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if name and spill:
            stores = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs:
            out.append(f"{name}: {regs.group(1)} registers, {stores} bytes spilled")
            name = None
    return out


def kernel_calls(gen, shape):
    """(K6 call, K7 call) over N_SETS input sets, the next set each call."""
    import chip_smoke

    scale, blk = shape[3] ** -0.5, fa._fused_block(shape[2])
    sets = []
    for _ in range(N_SETS):
        q, k, v, w = chip_smoke.flash_train_inputs(torch, gen, shape, torch.bfloat16)
        out, lse = fa._train_fwd(q, k, v, scale, blk, True)
        sets.append((q, k, v, w, lse, torch.sum(w.float() * out.float(), dim=-1)))
    it = iter(range(10**9))

    def fwd():
        q, k, v, *_ = sets[next(it) % N_SETS]
        return fa._train_fwd(q, k, v, scale, blk, False)

    def bwd():
        q, k, v, w, lse, delta = sets[next(it) % N_SETS]
        return fa._train_bwd(q, k, v, w, lse, delta, scale, False)

    return fwd, bwd


def qlora_micro_batch(gen):
    """One Gemma-7B QLoRA micro-batch (forward and backward) as phase 15 (b) runs it,
    on random weights and tokens."""
    import chip_smoke
    from ..models import gpt, lora
    from ..models.config import Config
    from ..ops import quant
    from ..training import finetune
    from ..training.step import tree_leaves

    cfg = Config.from_name(chip_smoke.GEMMA, attn_alg="quadratic")
    params = quant.quantize_model(gpt.init_params(cfg, 0, torch.bfloat16, "cuda"), "bnb.nf4")
    params = lora.add_lora_params(
        params, cfg, lora.LoRAConfig(r=8, alpha=16.0, query=True, value=True, mlp=True), gen,
        torch.bfloat16)
    for p, m in zip(tree_leaves(params), tree_leaves(lora.trainable_mask(params))):
        p.requires_grad_(m)
    ids = torch.randint(1, cfg.vocab_size, (1, chip_smoke.FAMILY_FT_T), generator=gen,
                        device="cuda")
    loss_fn = finetune.sft_loss_fn(cfg)
    return lambda: loss_fn(params, (ids, ids.clone())).backward()


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    args = parse_args(argv)
    build._require_cuda()
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from ..ops import quant

    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    real = {k: build.KERNELS[k] for k in NAMES}
    backend = quant.get_quant_backend()
    b, h, t, d = args.shape
    bounds = {"K6": chip_smoke.bound(*chip_smoke.flash_train_work(b, h, t, d, 2, False), True),
              "K7": chip_smoke.bound(*chip_smoke.flash_train_work(b, h, t, d, 2, True), True)}
    try:
        kernels = variants(args)
        order = list(kernels)
        for name, ks in kernels.items():
            for k in ks.values():
                for line in ptxas_lines(k.build_log):
                    print(f"{name} {line}", flush=True)
        fwd, bwd = kernel_calls(gen, args.shape)
        times = {name: {"K6": [], "K7": []} for name in kernels}
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                build.KERNELS.update(kernels[name])
                if rnd == 0:
                    chip_smoke.flash_train_case(torch, gen, "fused", args.shape, torch.bfloat16,
                                                f64=False)
                times[name]["K6"].append(chip_smoke.graph_ms(fwd, calls=2 * N_SETS))
                times[name]["K7"].append(chip_smoke.graph_ms(bwd, calls=2 * N_SETS))
        for name, per in times.items():
            for kname, ts in per.items():
                med, bd = statistics.median(ts), bounds[kname]["bound_ms"]
                print(f"{kname} {name}, {args.shape} bf16: median {med * 1e3:.1f} us over "
                      f"{len(ts)} rounds ({', '.join(f'{x * 1e3:.1f}' for x in ts)}); bound "
                      f"{bd * 1e3:.1f} us ({bounds[kname]['bound_by']}), {bd / med:.4f} of it   "
                      f"[{card}]", flush=True)
        if args.qlora_step:
            quant.set_quant_backend("pallas")  # K8 on the NF4 matmuls, as phase 15 sets it
            micro = qlora_micro_batch(gen)
            steps = {name: [] for name in kernels}
            for rnd in range(args.rounds):
                for name in (order if rnd % 2 == 0 else order[::-1]):
                    build.KERNELS.update(kernels[name])
                    if rnd == 0:
                        micro()
                    steps[name].append(host_ms(micro))
            for name, ts in steps.items():
                build.KERNELS.update(kernels[name])
                prof = chip_smoke.profile_device(torch, micro, f"QLoRA micro-batch, {name}")
                groups = prof.get("by_group_us") or {}
                k6, k7 = groups.get("K6 flash_train_fwd"), groups.get("K7 flash_train_bwd")
                share = ("not measured" if not prof["device_us"]
                         else f"{(k6 + k7) / prof['device_us']:.4f}")
                print(f"{chip_smoke.GEMMA} QLoRA micro-batch (T {chip_smoke.FAMILY_FT_T}) "
                      f"{name}: median {statistics.median(ts):.1f} ms over {len(ts)} rounds "
                      f"({', '.join(f'{x:.1f}' for x in ts)}), host clock; device "
                      f"{prof['device_us']} us, K6 {k6} us, K7 {k7} us, K6 + K7 {share} of "
                      f"the device time   [{card}]", flush=True)
    finally:
        build.KERNELS.update(real)
        quant.set_quant_backend(backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
