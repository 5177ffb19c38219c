"""Language-model dataset readers for the training recipes: ``MemmapDataset``
and ``Enwik8Dataset`` of ``fastmax_tpu/data/lm_datasets.py``, copied.

* ``MemmapDataset`` — nanoGPT-style uint16 ``train.bin``/``val.bin`` with
  random-offset sampling.
* ``Enwik8Dataset`` — byte-level random crops over the 90/5/5 MB enwik8 split.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterator

import numpy as np


class MemmapDataset:
    def __init__(self, bin_path: Path, block_size: int, seed: int = 0, dtype=np.uint16):
        self._data = np.memmap(str(bin_path), dtype=dtype, mode="r")
        self.block_size = block_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self._data) - self.block_size - 1
        while True:
            i = int(self._rng.integers(0, n))
            yield np.asarray(self._data[i : i + self.block_size + 1], dtype=np.int64)


class Enwik8Dataset:
    """Byte-level dataset over raw enwik8 (optionally .gz). splits follow
    the reference: train=first 90MB, val=next 5MB, test=last 5MB."""

    def __init__(self, path: Path, block_size: int, split: str = "train", seed: int = 0):
        path = Path(path)
        raw = gzip.open(path, "rb").read() if path.suffix == ".gz" else open(path, "rb").read()
        n = min(len(raw), 100_000_000)
        bounds = {"train": (0, int(n * 0.90)), "val": (int(n * 0.90), int(n * 0.95)),
                  "test": (int(n * 0.95), n)}
        lo, hi = bounds[split]
        self._data = np.frombuffer(raw[lo:hi], dtype=np.uint8)
        self.block_size = block_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self._data) - self.block_size - 1
        while True:
            i = int(self._rng.integers(0, n))
            yield self._data[i : i + self.block_size + 1].astype(np.int64)
