"""Language-model dataset readers for the training recipes: ``MemmapDataset``,
``Enwik8Dataset`` and ``SFTDataset`` of ``fastmax_tpu/data/lm_datasets.py``,
copied.

* ``MemmapDataset`` — nanoGPT-style uint16 ``train.bin``/``val.bin`` with
  random-offset sampling.
* ``Enwik8Dataset`` — byte-level random crops over the 90/5/5 MB enwik8 split.
* ``SFTDataset`` — tokenized instruction examples {input_ids, labels}, drawn
  at random and right-padded to the batch's longest (rounded up to 64), with
  ignore index -1 on padded labels.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

IGNORE_INDEX = -1


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


class SFTDataset:
    """Instruction-tuning examples: a list of dicts with 'input_ids' and
    'labels' arrays."""

    def __init__(self, examples: List[dict], seed: int = 0):
        self.examples = examples
        self._rng = np.random.default_rng(seed)

    @classmethod
    def load(cls, path: Path, seed: int = 0) -> "SFTDataset":
        """A reference-format ``.pt`` (a list of dicts of tensors, read with
        ``weights_only=True``) or the JAX package's ``.npz`` whose "examples"
        is an object array of such dicts (a pickle, so only files this
        program's data scripts wrote)."""
        path = Path(path)
        if path.suffix == ".pt":
            import torch

            data = torch.load(str(path), weights_only=True)
            examples = [{"input_ids": d["input_ids"].numpy(), "labels": d["labels"].numpy()}
                        for d in data]
        else:
            examples = list(np.load(str(path), allow_pickle=True)["examples"])
        return cls(examples, seed)

    def sample_batch(self, batch_size: int, max_seq_length: Optional[int] = None,
                     pad_multiple: int = 64) -> tuple:
        """``batch_size`` random examples right-padded to the longest, rounded
        up to ``pad_multiple`` and cut at ``max_seq_length``: (input_ids
        padded with 0, labels padded with IGNORE_INDEX), both (B, T) int64."""
        ix = self._rng.integers(0, len(self.examples), size=batch_size)
        input_ids = [np.asarray(self.examples[int(i)]["input_ids"], np.int64) for i in ix]
        labels = [np.asarray(self.examples[int(i)]["labels"], np.int64) for i in ix]
        max_len = max(len(s) for s in input_ids)
        max_len = ((max_len + pad_multiple - 1) // pad_multiple) * pad_multiple
        if max_seq_length:
            max_len = min(max_len, max_seq_length)

        def pad(seqs, value):
            out = np.full((batch_size, max_len), value, np.int64)
            for r, s in enumerate(seqs):
                s = s[:max_len]
                out[r, : len(s)] = s
            return out

        return pad(input_ids, 0), pad(labels, IGNORE_INDEX)

    def batches(self, batch_size: int, max_seq_length=None) -> Iterator[tuple]:
        while True:
            yield self.sample_batch(batch_size, max_seq_length)
