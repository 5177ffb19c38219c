"""Build, load and count the port's CUDA kernels.

Each source in ``fastmax_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``fastmax_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded
with ``ctypes``. ``build_all()`` starts one ``nvcc`` per source at once.
A library is named after a hash of its source and flags, so a changed
source is rebuilt. A failed build raises: nothing falls back to a plain
PyTorch version.

Every kernel keeps ``launches``, the number of times its wrapper launched
it; ``chip_smoke.py`` zeroes the counts before it drives the main path and
reads them after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, replaces: str, entry: str, argtypes: list):
        self.name = name
        self.source = CSRC_DIR / source
        self.replaces = replaces
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        # the shared headers beside the source are part of its build
        headers = b"".join(h.read_bytes() for h in sorted(self.source.parent.glob("*.cuh")))
        digest = hashlib.sha1(self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:12]}.so"

    def _start_build(self):
        out = self.library_path()
        if out.exists():
            return None
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        return proc, tmp, out, cmd

    def _finish_build(self, job) -> None:
        if job is None:
            return
        proc, tmp, out, cmd = job
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)

    def lib(self):
        if self._lib is None:
            _require_cuda()
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = _I
            lib.fm_error_string.argtypes = [_I]
            lib.fm_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, *args) -> None:
        """Call the C entry point on PyTorch's current stream; raise on a
        refused launch; count the launch."""
        lib = self.lib()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.entry)(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed: {lib.fm_error_string(err).decode()} ({err})")
        self.launches += 1


KERNELS = {
    "int4_rank1_matmul": Kernel(
        "int4_rank1_matmul", "int4_rank1_matmul.cu",
        "fastmax_tpu/ops/quant_pallas.py:428",  # and its per-layer twin at :344
        "fm_int4_rank1_matmul",
        # x, x_bf16, m, k, u, w, gk, gn, tk, v, n, y, part, splits, rows_per_split, stream
        [_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P]),
    "int8_decode_attention": Kernel(
        "int8_decode_attention", "int8_decode_attention.cu",
        "fastmax_tpu/ops/decode_attention.py:212",  # and its per-layer twin at :97
        "fm_int8_decode_attention",
        # q, q_bf16, kc, vc, ks, vs, pos, out, b, hq, g, s_len, d, scale, stream
        [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]),
    "flash_attention": Kernel(
        "flash_attention", "flash_attention.cu",
        "fastmax_tpu/ops/flash_attention.py:137",
        "fm_flash_attention",
        # q, k, v, out, bf16, b, hq, g, t, s, d, pos0, kv_len, scale, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]),
    "fastmax_fwd": Kernel(
        "fastmax_fwd", "fastmax_fwd.cu",
        "fastmax_tpu/ops/fastmax_pallas.py:503",  # and fastmax_pallas's forward alone at :649
        "fm_fastmax_fwd",
        # q, k, v, o, bf16, g, skv, sk, s3, skk, fpart, bh, n, d, chunk, p2, z, s3_rows, nsplit,
        # stream
        [_P, _P, _P, _P, _I] + [_P] * 6 + [_I] * 5 + [ctypes.c_float, _I, _I, _P]),
    "fastmax_bwd": Kernel(
        "fastmax_bwd", "fastmax_bwd.cu",
        "fastmax_tpu/ops/fastmax_pallas.py:568",
        "fm_fastmax_bwd",
        # q, k, v, dout, o, bf16, g, skv, sk, skk, s3, ds3, part, dq, dk, dv, bh, n, d, chunk,
        # p2, z, s3_rows, nsplit, stream
        [_P] * 5 + [_I] + [_P] * 10 + [_I] * 5 + [ctypes.c_float, _I, _I, _P]),
    "flash_train_fwd": Kernel(
        "flash_train_fwd", "flash_train_fwd.cu",
        "fastmax_tpu/ops/flash_attention.py:561",  # and flash_attention_trainable's at :230
        "fm_flash_train_fwd",
        # q, k, v, out, lse, bf16, bh, t, d, online block, scale, stream
        [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P]),
    "flash_train_bwd": Kernel(
        "flash_train_bwd", "flash_train_bwd.cu",
        "fastmax_tpu/ops/flash_attention.py:588",  # and flash_attention_trainable's at :358, :380
        "fm_flash_train_bwd",
        # q, k, v, dout, lse, delta, dq, dk, dv, bf16, bh, t, d, scale, stream
        [_P] * 9 + [_I] * 4 + [ctypes.c_float, _P]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return nvcc


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's kernels run on an NVIDIA GPU")


def build_all() -> dict:
    """Build every kernel, one nvcc per source, all started together; load
    them. Returns {name: build log}."""
    _require_cuda()
    jobs = [(k, k._start_build()) for k in KERNELS.values()]
    errors = []
    for k, job in jobs:
        try:
            k._finish_build(job)
        except RuntimeError as e:  # finish the other builds, then report all
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        k.lib()
    return {name: k.build_log for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def use_kernel(*tensors, plain: bool = False) -> bool:
    """Route a wrapper call: False (the plain PyTorch version) for tensors
    on the CPU or when the caller asks for ``plain``; True (the CUDA kernel)
    for CUDA tensors. Anything else, or a CUDA tensor without a usable CUDA
    runtime, raises: a CUDA tensor never reaches the plain version unasked."""
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(types)}")
    (dev,) = types
    if dev == "cuda":
        if plain:
            return False
        _require_cuda()
        return True
    if dev == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device type {dev!r}")
