"""Turn a pretraining ``out_dir`` into a deployable checkpoint directory
(counterpart of ``fastmax_tpu/scripts/convert_pretrained_checkpoint.py``):
the weights without the optimizer state, ``lit_config.json`` and the
tokenizer files.

    python -m fastmax_tpu_torch.scripts.convert_pretrained_checkpoint \\
        --checkpoint_dir out/pretrain --output_dir ckpt [--tokenizer_dir DIR]

The weights come, in the reference's order, from ``out_dir/state`` (the
port's torch train state, ``training/fit.save_train_state``) or else from
``out_dir/final/model`` (the npy layout that both packages' pretraining
write). The JAX package's ``state/`` is an orbax checkpoint, which only orbax
reads, and orbax needs JAX: such a directory raises (the port's resume reads
its own format only, ``training/pretrain.py``). No device is used.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Optional

from ..models.config import Config
from ..models.params import params_to_flat
from ..utils.checkpoint import save_flat_checkpoint


def convert_pretrained_checkpoint(
    checkpoint_dir: Path,
    output_dir: Path,
    tokenizer_dir: Optional[Path] = None,
) -> None:
    """checkpoint_dir: a training out_dir holding state/ and lit_config.json
    (at its top or in final/), or final/."""
    from ..training.fit import has_train_state, load_train_state

    checkpoint_dir = Path(checkpoint_dir)
    output_dir = Path(output_dir)
    cfg_path = next((c for c in (checkpoint_dir / "lit_config.json",
                                 checkpoint_dir / "final" / "lit_config.json") if c.is_file()),
                    None)
    if cfg_path is None:
        raise FileNotFoundError(f"no lit_config.json under {checkpoint_dir}")
    cfg = Config.from_json(cfg_path)

    state_dir = checkpoint_dir / "state"
    if state_dir.exists():
        if not has_train_state(state_dir):
            raise ValueError(
                f"{state_dir} holds no torch train state of the port: the JAX package writes "
                "its train state with orbax, which needs JAX to read, so the port cannot read "
                "it. Move state/ aside to convert the final/ weights instead.")
        output_dir.mkdir(parents=True, exist_ok=True)
        state = load_train_state(state_dir, "cpu")
        save_flat_checkpoint(params_to_flat(state.params, cfg), output_dir)
    elif (checkpoint_dir / "final" / "model").exists():
        output_dir.mkdir(parents=True, exist_ok=True)
        shutil.copytree(checkpoint_dir / "final" / "model", output_dir / "model",
                        dirs_exist_ok=True)
    else:
        raise FileNotFoundError(f"no weights under {checkpoint_dir}")

    cfg.to_json(output_dir / "lit_config.json")
    if tokenizer_dir:
        for f in Path(tokenizer_dir).glob("tokenizer*"):
            shutil.copy2(f, output_dir / f.name)
        gen_cfg = Path(tokenizer_dir) / "generation_config.json"
        if gen_cfg.is_file():
            shutil.copy2(gen_cfg, output_dir / gen_cfg.name)
    print(f"deployable checkpoint -> {output_dir}")


def main(args=None) -> None:
    """The command line: ``convert_pretrained_checkpoint``'s parameters as flags."""
    from ..utils.cli import CLI

    CLI(convert_pretrained_checkpoint, args)


if __name__ == "__main__":
    main()
