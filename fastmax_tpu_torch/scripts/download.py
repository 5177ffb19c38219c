"""Download model weights from the HuggingFace Hub (counterpart of
``fastmax_tpu/scripts/download.py``).

Without ``--repo_id`` it lists the models the registry knows, offline. With
one it fetches the repository's weights, configs and tokenizer files through
``huggingface_hub.snapshot_download`` into ``checkpoint_dir/repo_id`` (the
only step that needs the network; the token is ``--access_token`` or
``HF_TOKEN``), then, unless ``--convert false`` or ``--tokenizer_only``,
converts them in place with ``convert_hf_checkpoint`` under the repository's
last name, so that one command gives a checkpoint directory the port loads.

    python -m fastmax_tpu_torch.scripts.download --repo_id meta-llama/Llama-2-7b-hf
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..models.config import available_models


def download(
    repo_id: Optional[str] = None,
    checkpoint_dir: Path = Path("checkpoints"),
    access_token: Optional[str] = None,
    tokenizer_only: bool = False,
    convert: bool = True,
) -> None:
    if repo_id is None:
        print("Supported models:")
        for name in available_models():
            print(" ", name)
        return

    from huggingface_hub import snapshot_download

    directory = Path(checkpoint_dir) / repo_id
    allow = ["tokenizer*", "generation_config.json"] if tokenizer_only else [
        "*.safetensors*", "*.bin*", "*.json", "tokenizer*",
    ]
    snapshot_download(
        repo_id,
        local_dir=directory,
        allow_patterns=allow,
        token=access_token or os.getenv("HF_TOKEN"),
    )
    print(f"downloaded to {directory}")
    if convert and not tokenizer_only:
        from .convert_hf_checkpoint import convert_hf_checkpoint

        convert_hf_checkpoint(directory, model_name=Path(repo_id).name)


def main(args=None) -> None:
    from ..utils.cli import CLI

    CLI(download, args)


if __name__ == "__main__":
    main()
