"""Prepare a nanoGPT-style ``train.bin``/``val.bin`` token memmap (counterpart
of ``fastmax_tpu/scripts/prepare_openwebtext.py``).

    python -m fastmax_tpu_torch.scripts.prepare_openwebtext --source corpus.jsonl \\
        --checkpoint_dir checkpoints/meta-llama/Llama-2-7b-hf --destination_path data/owt

``source`` is a local ``.txt`` file, a ``.jsonl`` file of ``{"text": ...}``
records, a directory of ``.txt`` files (read in sorted order), or else the
name of a hub dataset, read through the ``datasets`` package, which needs
the network. Each text is tokenized with the checkpoint's tokenizer, an eos
appended, and the stream concatenated: uint16 below a vocabulary of 65 500
(the ``PackedDatasetBuilder`` rule), int32 above it. The last
max(int(len * test_size), 1) tokens are ``val.bin``, the rest ``train.bin``;
``meta.json`` records the dtype and the vocabulary size, which
``training/pretrain.py`` reads. No device is used.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

import numpy as np

from ..models.tokenizer import Tokenizer


def _iter_texts(source: str) -> Iterable[str]:
    p = Path(source)
    if p.is_file():
        if p.suffix == ".jsonl":
            with open(p, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        yield json.loads(line).get("text", "")
        else:
            yield p.read_text(encoding="utf-8")
        return
    if p.is_dir():
        for f in sorted(p.glob("**/*.txt")):
            yield f.read_text(encoding="utf-8")
        return
    # a hub dataset name (needs the network)
    from datasets import load_dataset

    for rec in load_dataset(source, split="train"):
        yield rec.get("text", "")


def prepare(
    source: str,
    checkpoint_dir: Path,
    destination_path: Path = Path("data/openwebtext"),
    test_size: float = 0.0005,
    seed: int = 2357,
) -> None:
    """Write ``train.bin``, ``val.bin`` and ``meta.json`` under
    ``destination_path``. ``seed`` is accepted, as the reference's, and
    unused: the split is the stream's tail."""
    destination_path = Path(destination_path)
    destination_path.mkdir(parents=True, exist_ok=True)
    tokenizer = Tokenizer(Path(checkpoint_dir))
    dtype = np.uint16 if tokenizer.vocab_size < 65500 else np.int32
    all_tokens = [np.asarray(tokenizer.encode(text, bos=False, eos=True), dtype)
                  for text in _iter_texts(source) if text]
    stream = np.concatenate(all_tokens)
    n_val = max(int(len(stream) * test_size), 1)
    for name, arr in (("train", stream[:-n_val]), ("val", stream[-n_val:])):
        out = destination_path / f"{name}.bin"
        arr.astype(dtype).tofile(out)
        print(f"{name}: {len(arr):,} tokens ({np.dtype(dtype).name}) -> {out}")
    (destination_path / "meta.json").write_text(
        json.dumps({"dtype": np.dtype(dtype).name, "vocab_size": tokenizer.vocab_size}))


def main(args=None) -> None:
    """The command line: ``prepare``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(prepare, args)


if __name__ == "__main__":
    main()
