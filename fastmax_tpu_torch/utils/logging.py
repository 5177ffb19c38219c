"""Metric logging: the CSV logger of ``fastmax_tpu/utils/logging.py``, copied.
The TensorBoard and W&B loggers are not ported yet."""

from __future__ import annotations

import csv
import time
from pathlib import Path


class CSVLogger:
    def __init__(self, out_dir: Path, name: str = "metrics"):
        self.path = Path(out_dir) / f"{name}.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # adopt an existing file's header so a resumed run appends to its
        # predecessor's history instead of truncating it
        self._fieldnames: list = []
        if self.path.exists():
            with open(self.path, newline="") as f:
                reader = csv.reader(f)
                self._fieldnames = next(reader, []) or []

    def log_dict(self, metrics: dict, step: int) -> None:
        row = {"step": step, "time": time.time(), **metrics}
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields:
            # the field set can grow mid-run (val_loss appears at the first
            # eval interval): re-read the existing rows once and rewrite
            # with the expanded header — O(1) memory in the steady state
            old_rows = []
            if self.path.exists() and self._fieldnames:
                with open(self.path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
            self._fieldnames.extend(new_fields)
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                w.writerows(old_rows)
                w.writerow(row)
        else:
            with open(self.path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writerow(row)

    def finalize(self) -> None:
        pass


def choose_logger(kind: str, out_dir: Path):
    if kind == "csv":
        return CSVLogger(out_dir)
    if kind in ("wandb", "tensorboard"):
        raise NotImplementedError(f"the {kind} logger is not ported yet (ROADMAP queue A, "
                                  "A4 slice 2): use 'csv'")
    raise ValueError(kind)
