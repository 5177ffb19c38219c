"""Instruction prompt templates and per-dataset record normalizers: a copy
of ``fastmax_tpu/data/prompts.py``.

Every instruction dataset funnels its records into one {instruction, input,
output} shape (``NORMALIZERS``, by ``--style``) and renders through one of
two templates (``STYLES``):

* alpaca / longform / csv: records already carry instruction/input/output.
* dolly: context -> input, response -> output.
* flan: inputs -> instruction, targets -> output; its template shows the
  task text under "### Instruction:".
* lima: records are {"conversations": [q, a, q, a, ...]}; the first pair
  becomes one example, or every (q, a) pair with ``include_multiturn``.
* booksum: chapter -> input, summary_text -> output with a fixed
  summarization instruction.
"""

from __future__ import annotations

from typing import Callable, Dict, List


def alpaca_prompt(example: dict) -> str:
    if example.get("input"):
        return (
            "Below is an instruction that describes a task, paired with an input that provides further context. "
            "Write a response that appropriately completes the request.\n\n"
            f"### Instruction:\n{example['instruction']}\n\n### Input:\n{example['input']}\n\n### Response:"
        )
    return (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{example['instruction']}\n\n### Response:"
    )


def flan_prompt(example: dict) -> str:
    return (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{example['instruction']}\n\n### Response:"
    )


# every style renders through one of the two reference templates; the
# dataset-specific part is the record normalization below
STYLES: Dict[str, Callable[[dict], str]] = {
    "alpaca": alpaca_prompt,
    "flan": flan_prompt,
    "dolly": alpaca_prompt,
    "lima": alpaca_prompt,
    "longform": alpaca_prompt,
    "csv": alpaca_prompt,
    "booksum": alpaca_prompt,
}


def _identity(record: dict) -> List[dict]:
    return [record]


def _dolly(record: dict) -> List[dict]:
    return [{
        "instruction": record.get("instruction", ""),
        "input": record.get("context", record.get("input", "")),
        "output": record.get("response", record.get("output", "")),
    }]


def _flan(record: dict) -> List[dict]:
    return [{
        "instruction": record.get("inputs", record.get("instruction", "")),
        "input": "",
        "output": record.get("targets", record.get("output", "")),
    }]


def _lima(record: dict, include_multiturn: bool = False) -> List[dict]:
    convo = record.get("conversations")
    if convo is None:
        return [record]
    if include_multiturn:
        return [
            {"instruction": convo[i], "input": "", "output": convo[i + 1]}
            for i in range(0, len(convo) - 1, 2)
        ]
    return [{"instruction": convo[0], "input": "", "output": convo[1]}]


def _booksum(record: dict) -> List[dict]:
    return [{
        "instruction": "Write a summary for the following text.",
        "input": record.get("chapter", record.get("input", "")),
        "output": record.get("summary_text", record.get("output", "")),
    }]


# style -> record -> list of {instruction, input, output} examples
NORMALIZERS: Dict[str, Callable[..., List[dict]]] = {
    "alpaca": _identity,
    "longform": _identity,
    "csv": _identity,
    "dolly": _dolly,
    "flan": _flan,
    "lima": _lima,
    "booksum": _booksum,
}
