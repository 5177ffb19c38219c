"""Profiling and throughput observability (counterpart of
``fastmax_tpu/utils/profiling.py``, with the reference's names):

* ``trace(log_dir)``: a ``torch.profiler`` capture (the host, and the card
  when there is one) written to ``log_dir`` as a Chrome/Perfetto trace;
* ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``);
* ``device_memory_stats``: the card's memory (``torch.cuda.memory_stats``)
  under the reference's keys;
* ``ThroughputMonitor``: windowed tokens/s, MFU and device-memory-rate use;
* ``hbm_bw_peak``: the card's data-sheet device-memory rate, by its name;
* ``enable_compile_cache``: the port's only compiled artefacts are its CUDA
  kernels, so this points ``kernels/build.py``'s build directory somewhere.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Optional

import torch

# data-sheet device-memory rate, bytes/s, by a part of the card's name
# (NVIDIA's H100 SXM, NVL and PCIe data sheets); the most specific name first
GPU_MEMORY_BYTES_PER_S = {"H100 NVL": 3.9e12, "H100 PCIe": 2.0e12, "H100 80GB HBM3": 3.35e12,
                          "H100 SXM": 3.35e12}


def enable_compile_cache(cache_dir: "str | Path | None" = None) -> Path:
    """Keep the kernels' builds in ``cache_dir`` (idempotent); returns the
    directory in use.

    The port compiles nothing but its CUDA kernels (``kernels/build.py``),
    and their build directory is already a persistent cache: a library is
    named after a hash of its source and flags, so a later run loads it
    without calling ``nvcc``. The default keeps the package's gitignored
    ``_build/``; a ``cache_dir`` moves the builds there."""
    from ..kernels import build

    if cache_dir is not None:
        build.BUILD_DIR = Path(cache_dir)
    return build.BUILD_DIR


@contextlib.contextmanager
def trace(log_dir: "str | Path | None" = None, host_tracer_level: int = 2):
    """Capture a profiler trace: ``with trace("dir"): step()`` writes
    ``dir/trace.json`` (default: ``torch-trace`` in the temporary directory).
    ``host_tracer_level`` > 2 also records the Python stack."""
    if log_dir is None:
        log_dir = Path(tempfile.gettempdir()) / "torch-trace"
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                with_stack=host_tracer_level > 2) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """Named region visible in the trace viewer."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """The card's memory: bytes allocated now and at peak (PyTorch's
    allocator), and the card's total. Off the card every figure is 0 and
    ``source`` says "none"."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0, "source": "none"}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
            "source": "runtime"}


def hbm_bw_peak(device=None) -> float:
    """The card's data-sheet device-memory rate in bytes/s; raises for a card
    the table does not name."""
    name = torch.cuda.get_device_name(device)
    for key, rate in GPU_MEMORY_BYTES_PER_S.items():
        if key in name:
            return rate
    raise ValueError(f"no data-sheet memory rate for {name!r}; add it to "
                     "GPU_MEMORY_BYTES_PER_S")


class ThroughputMonitor:
    """Windowed throughput metrics: tokens/s over the last ``window_size``
    updates, and on the card with ``flops_per_token``/``bytes_per_token`` the
    MFU (against the card's float32 peak, ``utils/flops.py``) and the share of
    its memory rate."""

    def __init__(self, window_size: int = 50, flops_per_token: Optional[float] = None,
                 bytes_per_token: Optional[float] = None):
        self._times = deque(maxlen=window_size)
        self._tokens = deque(maxlen=window_size)
        self.flops_per_token = flops_per_token
        self.bytes_per_token = bytes_per_token

    def update(self, tokens: int) -> None:
        self._times.append(time.perf_counter())
        self._tokens.append(tokens)

    def compute(self) -> dict:
        if len(self._times) < 2:
            return {}
        dt = self._times[-1] - self._times[0]
        toks = sum(list(self._tokens)[1:])
        tps = toks / max(dt, 1e-9)
        out = {"tokens_per_sec": tps}
        if not torch.cuda.is_available():
            return out
        if self.flops_per_token:
            from .flops import device_peak_flops

            peak = device_peak_flops(torch.cuda.get_device_name())
            if peak:
                out["mfu"] = tps * self.flops_per_token / peak
        if self.bytes_per_token:
            out["hbm_bw_util"] = tps * self.bytes_per_token / hbm_bw_peak()
        return out
