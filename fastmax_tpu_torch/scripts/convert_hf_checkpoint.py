"""Convert a HuggingFace checkpoint directory into the native checkpoint
directory (counterpart of ``fastmax_tpu/scripts/convert_hf_checkpoint.py``).

    python -m fastmax_tpu_torch.scripts.convert_hf_checkpoint \\
        --checkpoint_dir checkpoints/meta-llama/Llama-2-7b-hf [--model_name NAME] \\
        [--out_dir DIR] [--dtype bfloat16]

The per-family weight maps are the reference's: gpt-neox, falcon (7b against
40b/180B layer-norm names), llama and Mixtral (separate q/k/v fused into the
grouped-interleaved QKV, ``interleave_qkv``; tied embeddings written as
``lm_head.weight``) and phi. The conversion streams: each tensor is read
(``*.safetensors`` through the port's own lazy reader, ``*.bin`` through
``torch.load(mmap=True)``), renamed, cast by ``--dtype`` if given, written and
dropped before the next one, so a model larger than the host's memory
converts. Tensors keep their type otherwise (bfloat16 included).

Output (the layout of ``utils/checkpoint.py``):
  lit_config.json    the registry's config of ``model_name`` (default: the
                     directory's name)
  model/<name>.npy   one file per flat lit-gpt tensor name, model/index.json
No device is used.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..models.config import Config
from ..utils.checkpoint import npy_path, iter_flat_checkpoint, write_index, write_npy

# --------------------------------------------------------------------- maps


def neox_weight_map() -> Dict[str, Optional[str]]:
    return {
        "gpt_neox.embed_in.weight": "transformer.wte.weight",
        "gpt_neox.layers.{}.input_layernorm.bias": "transformer.h.{}.norm_1.bias",
        "gpt_neox.layers.{}.input_layernorm.weight": "transformer.h.{}.norm_1.weight",
        "gpt_neox.layers.{}.attention.query_key_value.bias": "transformer.h.{}.attn.attn.bias",
        "gpt_neox.layers.{}.attention.query_key_value.weight": "transformer.h.{}.attn.attn.weight",
        "gpt_neox.layers.{}.attention.dense.bias": "transformer.h.{}.attn.proj.bias",
        "gpt_neox.layers.{}.attention.dense.weight": "transformer.h.{}.attn.proj.weight",
        "gpt_neox.layers.{}.attention.rotary_emb.inv_freq": None,
        "gpt_neox.layers.{}.attention.bias": None,
        "gpt_neox.layers.{}.attention.masked_bias": None,
        "gpt_neox.layers.{}.post_attention_layernorm.bias": "transformer.h.{}.norm_2.bias",
        "gpt_neox.layers.{}.post_attention_layernorm.weight": "transformer.h.{}.norm_2.weight",
        "gpt_neox.layers.{}.mlp.dense_h_to_4h.bias": "transformer.h.{}.mlp.fc.bias",
        "gpt_neox.layers.{}.mlp.dense_h_to_4h.weight": "transformer.h.{}.mlp.fc.weight",
        "gpt_neox.layers.{}.mlp.dense_4h_to_h.bias": "transformer.h.{}.mlp.proj.bias",
        "gpt_neox.layers.{}.mlp.dense_4h_to_h.weight": "transformer.h.{}.mlp.proj.weight",
        "gpt_neox.final_layer_norm.bias": "transformer.ln_f.bias",
        "gpt_neox.final_layer_norm.weight": "transformer.ln_f.weight",
        "embed_out.weight": "lm_head.weight",
    }


def falcon_weight_map(model_name: str) -> Dict[str, Optional[str]]:
    m = {
        "transformer.word_embeddings.weight": "transformer.wte.weight",
        "transformer.h.{}.self_attention.query_key_value.weight": "transformer.h.{}.attn.attn.weight",
        "transformer.h.{}.self_attention.dense.weight": "transformer.h.{}.attn.proj.weight",
        "transformer.h.{}.mlp.dense_h_to_4h.weight": "transformer.h.{}.mlp.fc.weight",
        "transformer.h.{}.mlp.dense_4h_to_h.weight": "transformer.h.{}.mlp.proj.weight",
        "transformer.ln_f.bias": "transformer.ln_f.bias",
        "transformer.ln_f.weight": "transformer.ln_f.weight",
        "lm_head.weight": "lm_head.weight",
    }
    if "7b" in model_name:
        m["transformer.h.{}.input_layernorm.bias"] = "transformer.h.{}.norm_1.bias"
        m["transformer.h.{}.input_layernorm.weight"] = "transformer.h.{}.norm_1.weight"
    elif "40b" in model_name or "180B" in model_name:
        m["transformer.h.{}.ln_attn.bias"] = "transformer.h.{}.norm_1.bias"
        m["transformer.h.{}.ln_attn.weight"] = "transformer.h.{}.norm_1.weight"
        m["transformer.h.{}.ln_mlp.bias"] = "transformer.h.{}.norm_2.bias"
        m["transformer.h.{}.ln_mlp.weight"] = "transformer.h.{}.norm_2.weight"
    else:
        raise NotImplementedError(f"unknown falcon variant {model_name}")
    return m


def llama_weight_map(cfg: Config) -> Dict[str, Optional[str]]:
    m = {
        "model.embed_tokens.weight": "transformer.wte.weight",
        "model.layers.{}.input_layernorm.weight": "transformer.h.{}.norm_1.weight",
        "model.layers.{}.input_layernorm.bias": "transformer.h.{}.norm_1.bias",
        "model.layers.{}.self_attn.o_proj.weight": "transformer.h.{}.attn.proj.weight",
        "model.layers.{}.self_attn.rotary_emb.inv_freq": None,
        "model.layers.{}.post_attention_layernorm.weight": "transformer.h.{}.norm_2.weight",
        "model.layers.{}.post_attention_layernorm.bias": "transformer.h.{}.norm_2.bias",
        "model.norm.weight": "transformer.ln_f.weight",
        "model.norm.bias": "transformer.ln_f.bias",
        "lm_head.weight": "lm_head.weight",
    }
    if cfg.mlp_class_name == "LLaMAMoE":
        m.update({
            "model.layers.{}.block_sparse_moe.gate.weight": "transformer.h.{}.mlp.gate.weight",
            "model.layers.{}.block_sparse_moe.experts.{e}.w1.weight":
                "transformer.h.{}.mlp.experts.{e}.fc_1.weight",
            "model.layers.{}.block_sparse_moe.experts.{e}.w3.weight":
                "transformer.h.{}.mlp.experts.{e}.fc_2.weight",
            "model.layers.{}.block_sparse_moe.experts.{e}.w2.weight":
                "transformer.h.{}.mlp.experts.{e}.proj.weight",
        })
    else:
        m.update({
            "model.layers.{}.mlp.gate_proj.weight": "transformer.h.{}.mlp.fc_1.weight",
            "model.layers.{}.mlp.up_proj.weight": "transformer.h.{}.mlp.fc_2.weight",
            "model.layers.{}.mlp.down_proj.weight": "transformer.h.{}.mlp.proj.weight",
        })
    return m


def phi_weight_map() -> Dict[str, Optional[str]]:
    return {
        "model.embed_tokens.weight": "transformer.wte.weight",
        "model.layers.{}.input_layernorm.weight": "transformer.h.{}.norm_1.weight",
        "model.layers.{}.input_layernorm.bias": "transformer.h.{}.norm_1.bias",
        "model.layers.{}.self_attn.dense.weight": "transformer.h.{}.attn.proj.weight",
        "model.layers.{}.self_attn.dense.bias": "transformer.h.{}.attn.proj.bias",
        "model.layers.{}.mlp.fc1.weight": "transformer.h.{}.mlp.fc.weight",
        "model.layers.{}.mlp.fc1.bias": "transformer.h.{}.mlp.fc.bias",
        "model.layers.{}.mlp.fc2.weight": "transformer.h.{}.mlp.proj.weight",
        "model.layers.{}.mlp.fc2.bias": "transformer.h.{}.mlp.proj.bias",
        "model.final_layernorm.weight": "transformer.ln_f.weight",
        "model.final_layernorm.bias": "transformer.ln_f.bias",
        "lm_head.weight": "lm_head.weight",
        "lm_head.bias": "lm_head.bias",
    }


def interleave_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: Config) -> torch.Tensor:
    """Fuse separate q/k/v projections into the grouped-interleaved layout:
    the fused tensor cycles per query group through [q_1..q_{q_per_kv}, k, v]
    (ref: convert_hf_checkpoint.py:186-200). Weights (rows are out-features)
    and biases (1-D) alike."""
    g = cfg.n_query_groups
    groups = zip(q.chunk(g, 0), k.chunk(g, 0), v.chunk(g, 0))
    return torch.cat([t for trio in groups for t in trio], 0)


def split_qkv(qkv: torch.Tensor, cfg: Config) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of ``interleave_qkv`` (the lit -> HF direction)."""
    q_per_kv, hs = cfg.n_head // cfg.n_query_groups, cfg.head_size
    qs, ks, vs = [], [], []
    for blk in qkv.chunk(cfg.n_query_groups, 0):
        qs.append(blk[: q_per_kv * hs])
        ks.append(blk[q_per_kv * hs: (q_per_kv + 1) * hs])
        vs.append(blk[(q_per_kv + 1) * hs:])
    return torch.cat(qs, 0), torch.cat(ks, 0), torch.cat(vs, 0)


# ----------------------------------------------------------------- streaming


def iter_hf_tensors(checkpoint_dir: Path) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, tensor) from HF ``*.safetensors`` or ``*.bin`` shards,
    each backed by its file until it is used."""
    checkpoint_dir = Path(checkpoint_dir)
    st_files = sorted(checkpoint_dir.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            yield from iter_flat_checkpoint(f)
        return
    bin_files = sorted(f for f in checkpoint_dir.glob("*.bin") if f.name != "training_args.bin")
    if not bin_files:
        raise ValueError(f"Expected {str(checkpoint_dir)!r} to contain .safetensors or .bin files")
    for f in bin_files:
        yield from torch.load(str(f), map_location="cpu", weights_only=True, mmap=True).items()


def _template(name: str, idx: int) -> Tuple[str, int]:
    parts = name.split(".")
    number = int(parts[idx])
    parts[idx] = "{}"
    return ".".join(parts), number


class NativeCheckpointWriter:
    """Writes one .npy per tensor under <out_dir>/model/, then the index."""

    def __init__(self, out_dir: Path):
        self.model_dir = Path(out_dir) / "model"
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self.names = []

    def put(self, name: str, tensor: torch.Tensor) -> None:
        write_npy(npy_path(self.model_dir, name), tensor)
        self.names.append(name)

    def finish(self) -> None:
        write_index(self.model_dir, self.names)


def convert_hf_checkpoint(
    checkpoint_dir: Path,
    model_name: Optional[str] = None,
    out_dir: Optional[Path] = None,
    dtype: Optional[str] = None,
) -> Path:
    """Convert an HF checkpoint dir into the native format. Returns out_dir."""
    checkpoint_dir = Path(checkpoint_dir)
    if model_name is None:
        model_name = checkpoint_dir.name
    out_dir = Path(out_dir) if out_dir else checkpoint_dir
    cfg = Config.from_name(model_name)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg.to_json(out_dir / "lit_config.json")

    if "falcon" in model_name:
        weight_map, family = falcon_weight_map(model_name), "falcon"
    elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP", "LLaMAMoE"):
        weight_map, family = llama_weight_map(cfg), "llama"
    elif "phi" in model_name:
        weight_map, family = phi_weight_map(), "phi"
    else:
        weight_map, family = neox_weight_map(), "neox"

    writer = NativeCheckpointWriter(out_dir)
    # q/k/v shards awaiting fusion: layer -> {"weight"|"bias" -> {q|k|v}}
    pending: Dict[int, Dict[str, Dict[str, torch.Tensor]]] = {}
    saw_lm_head = False
    wte: Optional[torch.Tensor] = None
    cast = getattr(torch, dtype) if dtype else None

    for name, param in iter_hf_tensors(checkpoint_dir):
        if cast is not None and param.dtype != cast and param.is_floating_point():
            param = param.to(cast)
        layer = expert = None
        from_name = name
        if re.search(r"\.(layers|h)\.\d+\.", name):
            from_name, layer = _template(name, 2)
            if "block_sparse_moe.experts" in from_name:
                from_name, expert = _template(from_name, 5)
                from_name = re.sub(r"experts\.\{\}\.", "experts.{e}.", from_name)
        # q/k/v gathering for the split-projection families
        if family in ("llama", "phi") and any(t in name for t in ("q_proj", "k_proj", "v_proj")):
            proj, kind = name.split(".")[-2:]  # e.g. q_proj, weight
            trio = pending.setdefault(layer, {}).setdefault(kind, {})
            trio[proj[0]] = param
            if len(trio) == 3:
                writer.put(f"transformer.h.{layer}.attn.attn.{kind}",
                           interleave_qkv(trio["q"], trio["k"], trio["v"], cfg))
                del pending[layer][kind]
            continue

        to_name = weight_map.get(from_name)
        if expert is not None:
            if to_name is not None:
                writer.put(to_name.format(layer, e=expert), param)
            continue
        if to_name is None:
            if from_name not in weight_map:
                raise KeyError(f"no mapping for HF tensor {name!r}")
            continue
        if layer is not None:
            to_name = to_name.format(layer)
        saw_lm_head |= to_name == "lm_head.weight"
        if to_name == "transformer.wte.weight":
            wte = param
        writer.put(to_name, param)

    if family == "llama" and not saw_lm_head and wte is not None:
        # tied embeddings (ref convert_hf_checkpoint.py:182-183)
        writer.put("lm_head.weight", wte)
    writer.finish()
    return out_dir


def main(args=None) -> Path:
    from ..utils.cli import CLI

    return CLI(convert_hf_checkpoint, args)


if __name__ == "__main__":
    main()
