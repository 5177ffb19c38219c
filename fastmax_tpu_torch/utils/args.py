"""Run-hyperparameter dataclasses: a copy of ``fastmax_tpu/utils/args.py``."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class TrainArgs:
    save_interval: int = 1000
    log_interval: int = 1
    global_batch_size: int = 64
    micro_batch_size: int = 4
    lr_warmup_steps: int = 100
    epochs: Optional[int] = None
    epoch_size: Optional[int] = None
    max_tokens: Optional[int] = None
    max_seq_length: Optional[int] = None
    learning_rate: float = 1e-3
    weight_decay: float = 0.02
    beta1: float = 0.9
    beta2: float = 0.95
    max_norm: Optional[float] = 1.0
    min_lr: float = 6e-5
    max_iters: int = 10_000
    # adamw | adamw8bit | adafactor | lion — adamw8bit persists Adam moments
    # blockwise int8-quantized (training/quant_optim.py), the role of the
    # reference's PagedAdamW-under-quantization choice (finetune/lora.py:152-160)
    optimizer: str = "adamw"

    def gradient_accumulation_iters(self, devices: int = 1) -> int:
        ga = self.batch_size(devices) // self.micro_batch_size
        assert ga > 0, (self.global_batch_size, self.micro_batch_size, devices)
        return ga

    def batch_size(self, devices: int = 1) -> int:
        batch_size = self.global_batch_size // devices
        assert batch_size > 0
        return batch_size


@dataclass
class EvalArgs:
    interval: int = 600
    max_new_tokens: Optional[int] = None
    max_iters: int = 100


@dataclass
class IOArgs:
    train_data_dir: Optional[Path] = None
    val_data_dir: Optional[Path] = None
    checkpoint_dir: Optional[Path] = None
    out_dir: Path = Path("out")
    resume: bool = False
