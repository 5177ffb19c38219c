"""Metric logging (counterpart of ``fastmax_tpu/utils/logging.py``, copied):
CSV always, TensorBoard (``torch.utils.tensorboard``) and W&B (``wandb``)
when their packages are installed. ``choose_logger`` falls back to CSV with a
printed line when the chosen package is absent, as the reference does: that
is the user's choice of logger, not a device path."""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Optional


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


class WandbLogger:
    def __init__(self, project: str = "fastmax-tpu", name: Optional[str] = None, **kwargs):
        import wandb  # optional dependency

        self._run = wandb.init(project=project, name=name, **kwargs)

    def log_dict(self, metrics: dict, step: int) -> None:
        self._run.log(metrics, step=step)

    def finalize(self) -> None:
        self._run.finish()


class TensorBoardLogger:
    def __init__(self, out_dir: Path, name: str = "tb"):
        from torch.utils.tensorboard import SummaryWriter  # optional: needs tensorboard

        self._w = SummaryWriter(log_dir=str(Path(out_dir) / name))

    def log_dict(self, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._w.add_scalar(k, v, step)

    def finalize(self) -> None:
        self._w.close()


def choose_logger(kind: str, out_dir: Path, **kwargs):
    if kind == "csv":
        return CSVLogger(out_dir)
    if kind == "wandb":
        try:
            return WandbLogger(**kwargs)
        except ImportError:
            print("wandb not installed; falling back to CSV")
            return CSVLogger(out_dir)
    if kind == "tensorboard":
        try:
            return TensorBoardLogger(out_dir)
        except ImportError:
            print("tensorboard not installed; falling back to CSV")
            return CSVLogger(out_dir)
    raise ValueError(kind)
