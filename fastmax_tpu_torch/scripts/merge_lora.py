"""Merge a LoRA delta checkpoint into base weights and save a deployable
checkpoint (counterpart of ``fastmax_tpu/scripts/merge_lora.py``).

    python -m fastmax_tpu_torch.scripts.merge_lora --checkpoint_dir ckpt \\
        --lora_path out/qlora/lora_weights.safetensors [--out_dir DIR] [--device cpu]

The base is read from ``checkpoint_dir`` in ``precision`` onto the device,
the delta leaves (``training/finetune.py``'s ``lora_weights.safetensors``)
attached and merged by ``inference/generate.apply_finetuned``, and the plain
weights written in the npy layout with ``lit_config.json`` (default:
``checkpoint_dir/merged``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from ..inference.engine import default_device
from ..models.config import Config
from ..models.params import params_to_flat
from ..utils.checkpoint import load_model_params, save_flat_checkpoint


def merge_lora(
    checkpoint_dir: Path,
    lora_path: Path,
    out_dir: Optional[Path] = None,
    precision: str = "float32",
    device=None,
) -> None:
    """Load base + delta on the card (``device="cpu"`` for the CPU), merge,
    save the plain weights (no LoRA names)."""
    from ..inference.generate import apply_finetuned

    device = default_device(device)
    checkpoint_dir = Path(checkpoint_dir)
    out_dir = Path(out_dir) if out_dir else checkpoint_dir / "merged"
    cfg = Config.from_checkpoint(checkpoint_dir)
    dtype = getattr(torch, precision)
    _, params = load_model_params(checkpoint_dir, cfg, dtype, device)
    params = apply_finetuned(params, cfg, Path(lora_path), "lora", dtype)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_flat_checkpoint(params_to_flat(params, cfg), out_dir)
    cfg.to_json(out_dir / "lit_config.json")
    print(f"merged checkpoint -> {out_dir}")


def main(args=None) -> None:
    """The command line: ``merge_lora``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(merge_lora, args)


if __name__ == "__main__":
    main()
