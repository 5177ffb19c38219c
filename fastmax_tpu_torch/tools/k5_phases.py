"""Where K5's tensor-core kernel spends its time, phase by phase.

Builds a copy of ``csrc/fastmax_bwd.cu`` with ``clock64`` probes at thread 0 of
each CTA (the copy's outputs are not used: the counts overwrite a row of its
partial buffers), runs ``fastmax_bwd_tc_kernel`` once at the pretraining shape
(B=4 H=8 N=512 D=64, p = 2, chunk 128) in float32 and in bfloat16, and prints
the cycles a pair CTA spends in each phase (the mean over the pair CTAs) and
CTA 0's total. Phases: ``wait`` the step's barriers and ring wait, ``rows``
the chunk's rows and planes, ``rewind`` the S3 rewind (``fastmax_tc.cuh``'s
``s3_update``) with its write-back, ``planes`` the S3 tile's planes, ``dq2``, ``fold_q``, ``dv``, ``dk2``,
``fold_k``, ``update`` the dS3 update with its write-back.

    python -m fastmax_tpu_torch.tools.k5_phases

Needs an NVIDIA GPU and the CUDA toolkit; the anchors below are lines of
``fastmax_bwd.cu`` (the shared helpers of ``fastmax_tc.cuh`` are timed at their
call sites there), and the script stops if one is not found once.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..kernels import build
from ..ops import fastmax_kernels as fk

PHASES = ("wait", "rows", "rewind", "planes", "dq2", "fold_q", "dv", "dk2", "fold_k", "update")
TOTAL, DENSE = len(PHASES), len(PHASES) + 1

# (code of the source, the phase of the probe put before it, of the one put after it; None:
# no probe). A probe adds the cycles since the last probe to its phase.
PROBES = [
    ("          if (first) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, -1.f);\n", None, 2),
    ("  tile_planes<T>(sb);\n  const int r0 = 16 * (threadIdx.x >> 5);\n", None, 3),
    ("  fold<T>(oq, t, PairSmem::qs() + r0 * kLDF, pmj);\n", 4, 5),
    ("                               PairSmem::kTilePlane, 0, kPT);\n", None, 6),
    ("  fold<T>(ok, t, PairSmem::ks() + r0 * kLDF, pmj);\n", 7, 8),
    ("          if (second) ds3_update<T>(sb, ds3, p0, np, d, rows, inv_z2);\n", 9, 9),
    ("        __syncthreads();  // this step's tile is in\n", None, 0),
    ("        hold(r_beg, rows);\n", 0, 1),
]
PROLOGUE = ("__shared__ long long fm_prof[16];\n"
            "__device__ __forceinline__ void fm_tick(int i) {\n"
            "  if (threadIdx.x == 0) {\n"
            "    const long long t = clock64();\n"
            "    fm_prof[i] += t - fm_prof[15];\n"
            "    fm_prof[15] = t;\n"
            "  }\n"
            "}\n")


def _once(text: str, anchor: str, new: str) -> str:
    if text.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in fastmax_bwd.cu: {anchor!r}")
    return text.replace(anchor, new)


def instrumented(src_dir: Path) -> str:
    """The kernel's source with the probes; the counts go to row 0 of each CTA's dq
    buffer (CTA 0: its total at column DENSE)."""
    text = (src_dir / "fastmax_bwd.cu").read_text()
    head = "namespace {\n\nusing namespace fm;"
    text = _once(text, head, PROLOGUE + head)
    for anchor, before, after in PROBES:
        new = (f"fm_tick({before});\n" if before is not None else "") + anchor
        if after is not None:
            new += f"fm_tick({after});\n"
        text = _once(text, anchor, new)
    text = _once(text, "  fmtc::pair_setup(d);\n",
                 "  fmtc::pair_setup(d);\n"
                 "  for (int i = threadIdx.x; i < 16; i += blockDim.x) fm_prof[i] = 0;\n"
                 "  __syncthreads();\n  const long long t_start = clock64();\n"
                 "  if (threadIdx.x == 0) fm_prof[15] = t_start;\n")
    end = "        flush(gv, dv_acc, r_beg, rows, 1.f);\n      }\n    }\n  }\n}"
    text = _once(text, end, end[:-1] + "  __syncthreads();\n"
                 "  if (threadIdx.x == 0) {\n    fm_prof[%d] = clock64() - t_start;\n"
                 "    for (int i = 0; i <= %d; ++i) dq_acc[base + i] = fm_prof[i];\n  }\n}"
                 % (TOTAL, TOTAL))
    start = ("  for (int c0 = n - chunk; c0 >= 0; c0 -= chunk) {\n"
             "    // ---- 1. rewind the D x D state")
    text = _once(text, start, "  const long long t_dense = clock64();\n" + start)
    end = "          dskk[i] += akk[nt][e] / z2;\n        }\n    }\n  }\n}"
    text = _once(text, end, end[:-1] + "  __syncthreads();\n  if (threadIdx.x == 0) "
                 f"dq_acc[base + {DENSE}] = clock64() - t_dense;\n}}")
    return text


def run(dtype) -> dict:
    """Cycles by phase of one call at the pretraining shape."""
    tmp = Path(tempfile.mkdtemp())
    try:
        src = tmp / "csrc"
        shutil.copytree(build.CSRC_DIR, src)
        (src / "fastmax_bwd.cu").write_text(instrumented(src))
        real = build.KERNELS["fastmax_bwd"]
        kern = build.Kernel(real.name, str(src / "fastmax_bwd.cu"), real.replaces, real.entry,
                            real.argtypes)
        gen = torch.Generator(device="cuda").manual_seed(0)
        bh, n, d, chunk, z = 32, 512, 64, 128, 8.0 * math.sqrt(64)
        q, k, v, do = ((torch.randn((bh, n, d), generator=gen, device="cuda") * 0.5).to(dtype)
                       for _ in range(4))
        o, g, (s_kv, s_k, s_kkv, s_kk) = fk.fastmax_fwd_plain(q, k, v, 2, z, chunk)
        nsplit = fk._path_nsplit("tc", 2, d, bh, q.device)
        for _ in range(2):  # the second call is counted
            s3, ds3 = s_kkv.clone(), torch.zeros_like(s_kkv)
            part = torch.zeros((nsplit, 3, bh, n, d), device="cuda")
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            kern.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
                        int(dtype == torch.bfloat16), g.data_ptr(), s_kv.data_ptr(),
                        s_k.data_ptr(), s_kk.data_ptr(), s3.data_ptr(), ds3.data_ptr(),
                        part.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, n, d,
                        chunk, 1, float(z), s_kkv.shape[1], nsplit, 1)
            torch.cuda.synchronize()
        pairs = part[1:, 0, :, 0, :TOTAL + 1].reshape(-1, TOTAL + 1).double().mean(0)
        out = {name: float(c) for name, c in zip(PHASES, pairs)}
        out["pair_total"] = float(pairs[TOTAL])
        out["cta0_total"] = float(part[0, 0, :, 0, DENSE].double().mean())
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    build._require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    for dtype in (torch.float32, torch.bfloat16):
        res = run(dtype)
        print(f"K5 tc {str(dtype)[6:]}, B=4 H=8 N=512 D=64, cycles of a pair CTA: "
              + ", ".join(f"{k} {v / 1e3:.0f}k" for k, v in res.items() if k in PHASES)
              + f"; pair CTA total {res['pair_total'] / 1e3:.0f}k, CTA 0 total "
              f"{res['cta0_total'] / 1e3:.0f}k   [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
