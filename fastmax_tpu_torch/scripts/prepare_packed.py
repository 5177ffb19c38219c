"""Tokenize corpora into LITPKDS packed chunk files: a copy of
``fastmax_tpu/scripts/prepare_packed.py``.

Reads jsonl, ``.jsonl.zst`` (with ``zstandard``) and plain-text sources,
tokenizes each document with the checkpoint's tokenizer
(``models/tokenizer.py``, eos appended) and writes fixed-size token chunks
with ``data/packed_dataset.PackedDatasetBuilder``: the files
``training/pretrain.py --data_format packed`` reads. Per-source
subdirectories compose into ``CombinedDataset`` at training time.

    python -m fastmax_tpu_torch.scripts.prepare_packed --source_path corpus/ \
        --checkpoint_dir checkpoints/TinyLlama --destination_path data/packed

Works from local files; nothing is downloaded. No device is used.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np

from ..data.packed_dataset import PackedDatasetBuilder
from ..models.tokenizer import Tokenizer


def _iter_records(path: Path) -> Iterable[str]:
    if path.suffix == ".zst":
        import zstandard as zstd  # optional

        with open(path, "rb") as f, zstd.ZstdDecompressor().stream_reader(f) as r:
            import io

            for line in io.TextIOWrapper(r, encoding="utf-8"):
                if line.strip():
                    yield json.loads(line).get("text", "")
        return
    if path.suffix == ".jsonl":
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line).get("text", "")
        return
    yield path.read_text(encoding="utf-8")


def prepare(
    source_path: Path,
    checkpoint_dir: Path,
    destination_path: Path = Path("data/packed"),
    chunk_size: int = 2049 * 1024,
    prefix: str = "corpus",
    match: str = "*",
) -> None:
    source_path = Path(source_path)
    destination_path = Path(destination_path)
    destination_path.mkdir(parents=True, exist_ok=True)
    tokenizer = Tokenizer(Path(checkpoint_dir))

    builder = PackedDatasetBuilder(
        outdir=str(destination_path),
        prefix=prefix,
        chunk_size=chunk_size,
        sep_token=tokenizer.eos_id or 0,
        dtype="auto",
        vocab_size=tokenizer.vocab_size,
    )
    files = sorted(source_path.glob(match)) if source_path.is_dir() else [source_path]
    n_docs = 0
    for f in files:
        for text in _iter_records(f):
            if not text:
                continue
            toks = tokenizer.encode(text, bos=False, eos=True)
            builder.add_array(np.asarray(toks))
            n_docs += 1
    builder.write_reminder()
    print(f"{n_docs} documents -> {len(builder.filenames)} chunks in {destination_path}")


def main(args=None) -> None:
    """The command line: ``prepare``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(prepare, args)


if __name__ == "__main__":
    main()
