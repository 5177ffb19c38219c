"""Packed token dataset (counterpart of ``fastmax_tpu/data/packed_dataset.py``,
copied): the LITPKDS chunk files of lit-gpt, byte for byte, so the two
packages read each other's files.

File layout: b"LITPKDS" | uint64 version | uint8 dtype-code | uint64
chunk_size | raw tokens. ``PackedDataset`` shards the files across
processes, memory-maps ``n_chunks`` files at a time, permutes their blocks
with numpy's ``default_rng(seed)`` (the same order as the reference for the
same seed) and optionally wraps. ``native/loader.NativePackedDataset`` reads
the same files in a C++ prefetch thread.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Sequence

import numpy as np

dtypes = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16,
}

HDR_MAGIC = b"LITPKDS"
HDR_SIZE = 24  # bytes


def code(dtype) -> int:
    for k, v in dtypes.items():
        if v == dtype:
            return k
    raise ValueError(dtype)


class PackedDatasetBuilder:
    """Writes fixed-size token chunks (ref packed_dataset.py:62-130)."""

    def __init__(self, outdir, prefix, chunk_size, sep_token, dtype="auto", vocab_size=None):
        if dtype == "auto":
            if vocab_size is None:
                raise ValueError("vocab_size cannot be None when dtype='auto'")
            self._dtype = np.uint16 if vocab_size < 65500 else np.int32
        else:
            self._dtype = np.dtype(dtype).type
        self._counter = 0
        self._chunk_size = chunk_size
        self._outdir = outdir
        self._prefix = prefix
        self._sep_token = sep_token
        self._arr = np.full(chunk_size, sep_token, dtype=self._dtype)
        self._idx = 0
        self._version = 1
        self._filenames: List[str] = []

    def _write_chunk(self) -> None:
        filename = os.path.join(self._outdir, f"{self._prefix}_{self._counter:010d}.bin")
        with open(filename, "wb") as f:
            f.write(HDR_MAGIC)
            f.write(struct.pack("<Q", self._version))
            f.write(struct.pack("<B", code(self._dtype)))
            f.write(struct.pack("<Q", self._chunk_size))
            f.write(self._arr.tobytes(order="C"))
        self._filenames.append(filename)
        self._counter += 1
        self._arr.fill(self._sep_token)
        self._idx = 0

    @property
    def dtype(self):
        return self._dtype

    @property
    def filenames(self) -> List[str]:
        return self._filenames.copy()

    def add_array(self, arr: np.ndarray) -> None:
        while self._idx + arr.shape[0] > self._chunk_size:
            part_len = self._chunk_size - self._idx
            self._arr[self._idx : self._idx + part_len] = arr[:part_len]
            self._write_chunk()
            arr = arr[part_len:]
        self._arr[self._idx : self._idx + arr.shape[0]] = arr
        self._idx += arr.shape[0]

    def write_reminder(self) -> None:
        self._write_chunk()


def read_header(path) -> tuple:
    with open(path, "rb") as f:
        magic = f.read(len(HDR_MAGIC))
        if magic != HDR_MAGIC:
            raise ValueError(f"{path}: bad magic {magic!r}")
        (version,) = struct.unpack("<Q", f.read(8))
        (dtype_code,) = struct.unpack("<B", f.read(1))
        (chunk_size,) = struct.unpack("<Q", f.read(8))
    return version, dtypes[dtype_code], chunk_size


class PackedDataset:
    """Iterable over (block_size,) token arrays (ref packed_dataset.py:29-58)."""

    def __init__(self, filenames: Sequence, n_chunks: int, block_size: int,
                 seed: int = 12345, shuffle: bool = True, wrap: bool = False,
                 num_processes: int = 1, process_rank: int = 0):
        self._filenames = list(filenames)
        self._n_chunks = n_chunks
        self._block_size = block_size
        self._seed = seed
        self._shuffle = shuffle
        self._wrap = wrap
        self._num_processes = num_processes
        self._process_rank = process_rank

    def __iter__(self) -> Iterator[np.ndarray]:
        num_shards = self._num_processes
        shard_id = self._process_rank
        max_num_files = len(self._filenames) // num_shards * num_shards
        filenames = self._filenames[shard_id:max_num_files:num_shards]
        return _PackedIterator(
            filenames, self._n_chunks, self._block_size, self._seed,
            self._shuffle, self._wrap,
        )


class _PackedIterator:
    def __init__(self, filenames, n_chunks, block_size, seed, shuffle, wrap):
        self._filenames = filenames
        self._n_chunks = min(n_chunks, max(len(filenames), 1))
        self._block_size = block_size
        self._rng = np.random.default_rng(seed)
        self._shuffle = shuffle
        self._wrap = wrap
        self._file_idx = 0
        self._mmaps: List[np.memmap] = []
        self._block_idxs = None
        self._curr_idx = 0
        self._blocks_per_chunk = 0
        self._load_n_chunks()

    def _load_n_chunks(self):
        self._mmaps = []
        if self._n_chunks > len(self._filenames[self._file_idx:]):
            if not self._wrap:
                raise StopIteration
            self._file_idx = 0
        for i in range(self._n_chunks):
            filename = self._filenames[self._file_idx + i]
            _, dtype, chunk_size = read_header(filename)
            if chunk_size % self._block_size != 0:
                raise ValueError(f"chunk_size {chunk_size} not a multiple of block_size")
            self._dtype = dtype
            self._chunk_size = chunk_size
            self._mmaps.append(
                np.memmap(filename, mode="r", dtype=dtype, offset=HDR_SIZE, shape=(chunk_size,))
            )
        self._file_idx += self._n_chunks
        self._blocks_per_chunk = self._chunk_size // self._block_size
        n_all_blocks = self._n_chunks * self._blocks_per_chunk
        self._block_idxs = (
            self._rng.permutation(n_all_blocks) if self._shuffle else np.arange(n_all_blocks)
        )
        self._curr_idx = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._block_idxs is None or self._curr_idx >= len(self._block_idxs):
            try:
                self._load_n_chunks()
            except StopIteration:
                raise
        block_idx = int(self._block_idxs[self._curr_idx])
        chunk_id = block_idx // self._blocks_per_chunk
        elem_id = (block_idx % self._blocks_per_chunk) * self._block_size
        arr = np.asarray(self._mmaps[chunk_id][elem_id : elem_id + self._block_size])
        self._curr_idx += 1
        return arr.astype(np.int64)


class CombinedDataset:
    """Weighted random mixture of datasets (ref packed_dataset.py:216-239)."""

    def __init__(self, datasets: Sequence, seed: int, weights: Optional[Sequence[float]] = None):
        self._datasets = list(datasets)
        self._seed = seed
        n = len(self._datasets)
        if weights is None:
            weights = [1 / n] * n
        total = sum(weights)
        self._weights = [w / total for w in weights]

    def __iter__(self):
        rng = np.random.default_rng(self._seed)
        iters = [iter(d) for d in self._datasets]
        while True:
            (i,) = rng.choice(len(iters), size=1, p=self._weights)
            try:
                yield next(iters[int(i)])
            except StopIteration:
                return


def batch_iterator(dataset, batch_size: int, drop_last: bool = True):
    """Batch an iterable of (block,) arrays into (B, block) matrices."""
    buf = []
    for item in dataset:
        buf.append(item)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
    if buf and not drop_last:
        yield np.stack(buf)
