"""Convert a lit-format checkpoint back to HuggingFace names and layout
(counterpart of ``fastmax_tpu/scripts/convert_lit_checkpoint.py``).

    python -m fastmax_tpu_torch.scripts.convert_lit_checkpoint \\
        --checkpoint_path ckpt --output_path hf/model.safetensors [--model_name NAME]

The weight maps are the HF converter's (``scripts/convert_hf_checkpoint.py``),
inverted; the fused grouped QKV of the llama and phi families is split back
into q/k/v projections (``split_qkv``). Unmerged LoRA or adapter tensors are
refused: merge them first (``scripts/merge_lora.py``). The input is read one
tensor at a time (``utils/checkpoint.iter_flat_checkpoint``, backed by its
file); the split q/k/v are the only copies held until the output, a
``.safetensors``/``.pth`` file or an npy directory, is written. No device is
used.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

from ..models.config import Config
from ..utils.checkpoint import iter_flat_checkpoint, save_flat_checkpoint
from .convert_hf_checkpoint import (falcon_weight_map, llama_weight_map, neox_weight_map,
                                    phi_weight_map, split_qkv)


def _invert(weight_map: Dict[str, Optional[str]]) -> Dict[str, str]:
    return {v: k for k, v in weight_map.items() if v is not None}


def convert_lit_checkpoint(
    checkpoint_path: Path,
    output_path: Path,
    model_name: Optional[str] = None,
) -> None:
    checkpoint_path = Path(checkpoint_path)
    cfg_dir = checkpoint_path if checkpoint_path.is_dir() else checkpoint_path.parent
    cfg = Config.from_checkpoint(cfg_dir, **({} if model_name is None else {"name": model_name}))
    name = model_name or cfg.name

    if "falcon" in name:
        inv, family = _invert(falcon_weight_map(name)), "falcon"
    elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP", "LLaMAMoE"):
        inv, family = _invert(llama_weight_map(cfg)), "llama"
    elif "phi" in name:
        inv, family = _invert(phi_weight_map()), "phi"
    else:
        inv, family = _invert(neox_weight_map()), "neox"

    out: Dict[str, torch.Tensor] = {}
    for lit_name, tensor in iter_flat_checkpoint(checkpoint_path):
        if "lora_" in lit_name or "adapter" in lit_name:
            raise ValueError(f"{lit_name!r} is a PEFT delta: merge it first "
                             "(scripts/merge_lora.py), as the reference converter requires")
        parts = lit_name.split(".")
        layer = None
        if len(parts) > 2 and parts[1] == "h":
            layer = parts[2]
            parts[2] = "{}"
        template = ".".join(parts)
        if family in ("llama", "phi") and template.startswith("transformer.h.{}.attn.attn."):
            for proj, part in zip(("q_proj", "k_proj", "v_proj"), split_qkv(tensor, cfg)):
                out[f"model.layers.{layer}.self_attn.{proj}.{parts[-1]}"] = part
            continue
        expert = None
        if "mlp.experts." in template:  # transformer.h.{}.mlp.experts.E.<linear>...
            expert, parts[5] = parts[5], "{e}"
            template = ".".join(parts)
        hf_tmpl = inv.get(template)
        if hf_tmpl is None:
            continue
        # the named {e} field first: str.format cannot mix it with the positional one
        if expert is not None:
            hf_tmpl = hf_tmpl.replace("{e}", expert)
        out[hf_tmpl.format(layer) if layer is not None else hf_tmpl] = tensor

    save_flat_checkpoint(out, Path(output_path))
    print(f"wrote {len(out)} tensors -> {output_path}")


def main(args=None) -> None:
    """The command line: ``convert_lit_checkpoint``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(convert_lit_checkpoint, args)


if __name__ == "__main__":
    main()
