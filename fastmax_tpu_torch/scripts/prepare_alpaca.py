"""Prepare instruction datasets (alpaca / flan / dolly / lima / longform /
csv / booksum style) into tokenized train/test files: a copy of
``fastmax_tpu/scripts/prepare_alpaca.py``.

Any JSON/JSONL/CSV file becomes {input_ids, labels} examples with the prompt
masked to ignore_index, saved as ``train.npz``/``test.npz`` (an object array
of dicts under "examples"): the files ``training/finetune.py`` reads
(``data/lm_datasets.SFTDataset``). Per-dataset field layouts are handled by
``--style`` through ``data/prompts.NORMALIZERS``; the response is appended to
the prompt with no separator.

    python -m fastmax_tpu_torch.scripts.prepare_alpaca --data_file alpaca.json \
        --checkpoint_dir checkpoints/meta-llama/Llama-2-7b-hf --destination_path data/alpaca

It needs the checkpoint's tokenizer (``models/tokenizer.py``) and works from
a local file; nothing is downloaded. No device is used.
"""

from __future__ import annotations

import csv as csv_mod
import json
from pathlib import Path
from typing import List

import numpy as np

from ..data.lm_datasets import IGNORE_INDEX
from ..data.prompts import NORMALIZERS, STYLES
from ..models.tokenizer import Tokenizer


def load_records(path: Path) -> List[dict]:
    path = Path(path)
    if path.suffix == ".json":
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    if path.suffix == ".jsonl":
        with open(path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]
    if path.suffix == ".csv":
        with open(path, encoding="utf-8", newline="") as f:
            return list(csv_mod.DictReader(f))
    raise ValueError(f"unsupported dataset file {path}")


def prepare_example(
    example: dict,
    tokenizer: Tokenizer,
    max_seq_length: int,
    mask_inputs: bool = True,
    style: str = "alpaca",
) -> dict:
    """Tokenize one record; prompt tokens get ignore_index labels
    (ref prepare_alpaca.py prepare_sample). The response is appended with no
    separator, exactly as the reference concatenates
    (prepare_alpaca.py:121)."""
    full_prompt = STYLES[style](example)
    full = full_prompt + example.get("output", "")
    enc_prompt = tokenizer.encode(full_prompt, max_length=max_seq_length)
    enc_full = tokenizer.encode(full, eos=True, max_length=max_seq_length)
    labels = enc_full.copy().astype(np.int64)
    if mask_inputs:
        labels[: len(enc_prompt)] = IGNORE_INDEX
    return {"input_ids": enc_full.astype(np.int64), "labels": labels}


def prepare(
    data_file: Path,
    checkpoint_dir: Path,
    destination_path: Path = Path("data/alpaca"),
    test_split_fraction: float = 0.04,
    max_seq_length: int = 512,
    mask_inputs: bool = True,
    style: str = "alpaca",
    seed: int = 42,
    include_multiturn: bool = False,
) -> None:
    """``include_multiturn``: lima style only — emit every (question, answer)
    pair of a conversation instead of just the first
    (ref prepare_lima.py:105-116)."""
    destination_path = Path(destination_path)
    destination_path.mkdir(parents=True, exist_ok=True)
    tokenizer = Tokenizer(Path(checkpoint_dir))
    normalize = NORMALIZERS.get(style, lambda r: [r])
    kw = {"include_multiturn": include_multiturn} if style == "lima" else {}
    records = [ex for r in load_records(data_file) for ex in normalize(r, **kw)]

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(records))
    n_test = int(len(records) * test_split_fraction)
    splits = {
        "test": [records[i] for i in perm[:n_test]],
        "train": [records[i] for i in perm[n_test:]],
    }
    for split, recs in splits.items():
        examples = [
            prepare_example(r, tokenizer, max_seq_length, mask_inputs, style) for r in recs
        ]
        out = destination_path / f"{split}.npz"
        np.savez_compressed(out, examples=np.asarray(examples, dtype=object))
        print(f"{split}: {len(examples)} examples -> {out}")


def main(args=None) -> None:
    """The command line: ``prepare``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(prepare, args)


if __name__ == "__main__":
    main()
