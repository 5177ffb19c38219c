"""The C++ prefetch loader for packed datasets (counterpart of
``fastmax_tpu/native/loader.py``).

``NativePackedDataset`` has ``data/packed_dataset.PackedDataset``'s iterator
contract, but decodes and shuffles blocks in a C++ thread
(``native/packed_loader.cpp``, the port's own copy of the reference's
source), so the Python thread stays free to feed the card. The library is
built from that source at first use, with ``g++``, into the package's
gitignored ``_build/``, named after a hash of the source and flags, or ahead
of time by ``python -m fastmax_tpu_torch.native.build``. Where it neither
loads nor builds (no ``g++``), ``native_available()`` is False and the
reader falls back, with a warning, to ``data/packed_dataset.PackedDataset``
over the same files, as the reference does when its library is absent.
``native=False`` asks for that reader outright. ``reader`` says which one the
last iteration ran ("native" or "numpy").

The C++ thread shuffles each file's blocks with its own SplitMix64 stream,
not numpy's generator: shuffled, the two readers give the same blocks in
another order; unshuffled, the same blocks in the same order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "packed_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"packed_loader-{digest}.so"


def build() -> Path:
    """Compile the loader (once per source and flags); returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native packed loader is built with g++ "
                           "(or pass native=False for the numpy reader)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # concurrent builders race only on the rename
    return out


def _load_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.pl_open.restype = ctypes.c_void_p
            lib.pl_open.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
                ctypes.c_long, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
            ]
            lib.pl_next.restype = ctypes.c_long
            lib.pl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
            lib.pl_close.restype = None
            lib.pl_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the C++ library loads, building it first if it is not built."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativePackedDataset:
    """Iterable over (block_size,) int64 arrays, C++-prefetched; with
    ``native=False``, or where the library cannot be built, ``PackedDataset``
    over the same files."""

    def __init__(self, filenames: Sequence, block_size: int, *, seed: int = 12345,
                 shuffle: bool = True, wrap: bool = False, n_prefetch: int = 16,
                 num_processes: int = 1, process_rank: int = 0, native: bool = True):
        self._filenames = [str(f) for f in filenames][process_rank::num_processes]
        self._block_size = block_size
        self._seed = seed
        self._shuffle = shuffle
        self._wrap = wrap
        self._n_prefetch = n_prefetch
        self._native = native
        self.reader = None  # "native" or "numpy", once iterated

    def __iter__(self) -> Iterator[np.ndarray]:
        native = self._native and native_available()
        if self._native and not native:
            warnings.warn("the native packed loader could not be built (g++ missing or the "
                          "build failed): reading with the numpy PackedDataset", RuntimeWarning,
                          stacklevel=2)
        if not native:
            from ..data.packed_dataset import PackedDataset

            self.reader = "numpy"
            yield from PackedDataset(
                self._filenames, n_chunks=min(8, max(len(self._filenames), 1)),
                block_size=self._block_size, seed=self._seed,
                shuffle=self._shuffle, wrap=self._wrap,
            )
            return
        lib = _load_lib()
        self.reader = "native"
        files = (ctypes.c_char_p * len(self._filenames))(
            *[f.encode() for f in self._filenames]
        )
        handle = lib.pl_open(files, len(self._filenames), self._block_size,
                             self._n_prefetch, self._seed,
                             int(self._shuffle), int(self._wrap))
        if not handle:
            raise RuntimeError("pl_open failed")
        buf = np.empty(self._block_size, np.int32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        try:
            while True:
                n = lib.pl_next(handle, ptr)
                if n == 0:
                    return
                yield buf[:n].astype(np.int64)
        finally:
            lib.pl_close(handle)
