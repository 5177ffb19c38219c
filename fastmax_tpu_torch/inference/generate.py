"""Generation command line (counterpart of ``fastmax_tpu/inference/generate.py``).

  python -m fastmax_tpu_torch.inference.generate --checkpoint_dir ckpt \\
      --prompt "Hello, my name is" --quantize bnb.nf4 [--device cpu]

``load_and_prepare`` reads a checkpoint directory (``lit_config.json``, the
weights through ``utils/checkpoint.load_model_params``, one tensor at a
time onto the device), attaches a finetuned file (``apply_finetuned``:
``full`` replaces the weights, ``lora`` sets the delta leaves and merges
them, ``adapter``/``adapter_v2`` set the adapter leaves) and quantizes. ``main`` wraps the prompt (``--prompt_style``), runs
``InferenceEngine.generate`` ``num_samples`` times and prints each text, then
``Time for inference ...`` with tokens/sec and, on the card, the peak memory
to stderr.

Sampling noise comes from a ``torch.Generator`` seeded with ``--seed`` where
the reference splits a ``jax.random`` key, so sampled text (temperature > 0)
differs from the JAX package's for the same seed; greedy text (temperature
0) does not depend on it.

``--gptq_calib`` names a plain-text file: its tokens, cut to the block
size, calibrate GPTQ for a 4-bit ``--quantize`` mode (``ops/gptq.py``).

``--speculative_k k`` decodes speculatively (``inference/speculative.py``),
k drafted tokens a verify forward, drafted by prompt lookup or, with
``--draft_checkpoint_dir``, by a small model of the same vocabulary (loaded
as the target is, with its ``--quantize`` and ``--precision``); the engines
are sized with k+1 positions of headroom. Greedy text is the plain decode's;
sampled text follows the same distribution.

``--tp N`` / ``--fsdp M`` shard the model over a (data, fsdp, model) mesh
of one process per rank (``parallel/sharding.py``); start it with torchrun,
each rank on ``cuda:LOCAL_RANK``:

  torchrun --nproc_per_node 2 -m fastmax_tpu_torch.inference.generate \
      --checkpoint_dir ckpt --prompt "Hello" --tp 2

Every rank runs the same engine on its shard; rank 0 prints. A dense
checkpoint without a finetuned file or ``--quantize`` is read slice by slice,
each rank its own (``utils/sharded_load.load_sharded_model_params``); any
other load reads the whole tree, and the engine cuts it after resolving the
weights mode. Started alone at tp * fsdp > 1, it raises with the torchrun
line to use.
"""

from __future__ import annotations

import io
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.config import Config
from ..models.tokenizer import Tokenizer
from .engine import InferenceEngine, default_device


MODULE = "fastmax_tpu_torch.inference.generate"


def rank_setup(tp: int, fsdp: int, device, module: str = MODULE):
    """(mesh, device) of an entry point: no mesh and ``default_device`` at
    tp * fsdp == 1; else the torchrun mesh (``sharding.mesh_from_env``) and
    this rank's device."""
    from ..parallel import collectives as col
    from ..parallel.sharding import mesh_from_env

    mesh = mesh_from_env(tp, fsdp, module)
    return mesh, (default_device(device) if mesh is None else col.rank_device(device))


def load_and_prepare(
    checkpoint_dir: Path,
    *,
    quantize: Optional[str] = None,
    attn_alg: Optional[str] = None,
    finetuned_path: Optional[Path] = None,
    method: str = "lora",
    precision: str = "bfloat16",
    tp: int = 1,
    fsdp: int = 1,
    gptq_calib_tokens=None,
    device=None,
):
    """(config, params) of ``checkpoint_dir`` in ``precision`` on ``device``
    (default: the card), with ``finetuned_path`` attached, then quantized.
    ``gptq_calib_tokens`` ((B, T) token ids) with a 4-bit ``quantize`` mode
    quantizes by GPTQ against those activations (``ops/gptq.py``, on the
    device) instead of rounding to nearest. At tp or fsdp > 1 (one rank of
    the torchrun mesh, ``rank_setup``) a dense load without a finetuned file
    gives this rank's ``ShardedParams``, read slice by slice; any other, the
    whole tree, for the engine to cut."""
    from ..utils.checkpoint import load_model_params

    checkpoint_dir = Path(checkpoint_dir)
    kw = {"attn_alg": attn_alg} if attn_alg else {}
    cfg = Config.from_checkpoint(checkpoint_dir, **kw)
    dtype = getattr(torch, precision)
    mesh, device = rank_setup(tp, fsdp, device)
    if mesh is not None:
        if finetuned_path is None and not quantize:
            from ..utils.sharded_load import load_sharded_model_params

            return load_sharded_model_params(checkpoint_dir, mesh, cfg=cfg, dtype=dtype,
                                             tp=tp > 1, device=device)
    _, params = load_model_params(checkpoint_dir, cfg, dtype, device)
    if finetuned_path is not None:
        params = apply_finetuned(params, cfg, Path(finetuned_path), method, dtype)
    if quantize:
        from ..ops.gptq import FOUR_BIT_KINDS, gptq_quantize_model

        if gptq_calib_tokens is not None and quantize in FOUR_BIT_KINDS:
            params = gptq_quantize_model(params, cfg, gptq_calib_tokens,
                                         kind=FOUR_BIT_KINDS[quantize],
                                         double_quant=quantize.endswith("-dq"), device=device)
        else:
            from ..ops.quant import quantize_model

            params = quantize_model(params, quantize)
    return cfg, params


def apply_finetuned(params, cfg, finetuned_path: Path, method: str, dtype):
    """Attach finetuned weights, on the parameters' device.

    method "full": the file holds a complete lit-named state dict, which
    replaces every parameter. "lora", "adapter", "adapter_v2": the file holds
    leaves named by their tree paths ("blocks.attn.attn.lora_A",
    "blocks.attn.adapter.wte", ..., as ``training/finetune.py`` writes them),
    set in ``dtype``; LoRA deltas are merged into the base, adapter leaves
    stay (the forward applies them; the file has no ``on``, see
    ``models/adapter.apply_adapter_attention``)."""
    from ..models import lora as lora_mod
    from ..utils.checkpoint import load_flat_checkpoint

    if method not in ("full", "lora", "adapter", "adapter_v2"):
        raise ValueError(f"unknown finetuning method {method!r}")
    device = params["wte"].device
    delta = load_flat_checkpoint(Path(finetuned_path))
    if method == "full":
        from ..models.params import flat_to_params

        return flat_to_params(delta, cfg, dtype, device)
    for name, value in delta.items():
        *parents, leaf = name.split(".")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.to(device=device, dtype=dtype)
    return lora_mod.merge_lora(params) if method == "lora" else params


def main(
    prompt: str = "Hello, my name is",
    checkpoint_dir: Path = Path("checkpoints"),
    num_samples: int = 1,
    max_new_tokens: int = 50,
    top_k: Optional[int] = 200,
    temperature: float = 0.8,
    quantize: Optional[str] = None,
    attn_alg: Optional[str] = None,
    finetuned_path: Optional[Path] = None,
    method: str = "lora",
    prompt_style: Optional[str] = None,
    precision: str = "bfloat16",
    tp: int = 1,
    fsdp: int = 1,
    seed: int = 1234,
    weights_mode: str = "auto",
    kv_cache_dtype: Optional[str] = None,
    speculative_k: int = 0,
    draft_checkpoint_dir: Optional[Path] = None,
    gptq_calib: Optional[Path] = None,
    device=None,
) -> None:
    """Generate text samples from a checkpoint on the card (``device="cpu"``
    for the CPU). weights_mode: see ``InferenceEngine``; kv_cache_dtype:
    int8 for the quantized KV cache, bfloat16, ...; gptq_calib: a plain-text
    calibration file for GPTQ under a 4-bit ``quantize`` mode (its tokens cut
    to the block size); speculative_k > 0: speculative decoding with k drafts
    a verify step, drafted by prompt lookup or by the model in
    draft_checkpoint_dir (the same vocabulary); tp, fsdp > 1: one rank of a
    torchrun mesh (see the module's docstring)."""
    mesh, device = rank_setup(tp, fsdp, device)
    # rank 0 speaks for the mesh
    text_out, log_out = (sys.stdout, sys.stderr) if mesh is None or mesh.leader else \
        (io.StringIO(), io.StringIO())
    tokenizer = Tokenizer(Path(checkpoint_dir))
    calib_tokens = None
    if gptq_calib is not None:
        ids = tokenizer.encode(Path(gptq_calib).read_text())
        t = min(len(ids), Config.from_checkpoint(Path(checkpoint_dir)).block_size)
        calib_tokens = np.asarray(ids[:t], np.int32)[None]
    cfg, params = load_and_prepare(
        checkpoint_dir, quantize=quantize, attn_alg=attn_alg, finetuned_path=finetuned_path,
        method=method, precision=precision, tp=tp, fsdp=fsdp, gptq_calib_tokens=calib_tokens,
        device=device)
    if prompt_style:
        from ..data.prompts import STYLES

        prompt = STYLES[prompt_style]({"instruction": prompt, "input": ""})
    encoded = tokenizer.encode(prompt)
    prompt_len = len(encoded)
    max_returned = prompt_len + max_new_tokens
    engine = InferenceEngine(
        cfg, params, max_seq_length=max_returned + (speculative_k + 1 if speculative_k else 0),
        batch_size=1, weights_mode=weights_mode,
        cache_dtype=getattr(torch, kv_cache_dtype) if kv_cache_dtype else None, device=device,
        mesh=mesh)
    spec = None
    if speculative_k and draft_checkpoint_dir:
        from .speculative import DraftSpeculativeDecoder

        dcfg, dparams = load_and_prepare(Path(draft_checkpoint_dir), quantize=quantize,
                                         precision=precision, tp=tp, fsdp=fsdp, device=device)
        draft_engine = InferenceEngine(dcfg, dparams, max_seq_length=engine.max_seq_length,
                                       batch_size=1, weights_mode=weights_mode, device=device,
                                       mesh=mesh)
        spec = DraftSpeculativeDecoder(engine, draft_engine, k=speculative_k)
    elif speculative_k:
        from .speculative import SpeculativeDecoder

        spec = SpeculativeDecoder(engine, k=speculative_k)
    print(f"model {cfg.name}: attn_alg={cfg.attn_alg}"
          + (f", quantized {quantize}" if quantize else "")
          + ("" if mesh is None else f", {mesh.shape} mesh of {mesh.size} ranks"
             + (f", kept whole: {', '.join(engine.shard.kept_whole)}"
                if engine.shard.kept_whole else "")), file=log_out)

    generator = torch.Generator(device=device).manual_seed(seed)
    for i in range(num_samples):
        t0 = time.perf_counter()
        out = (spec or engine).generate(torch.from_numpy(encoded), max_returned,
                                        temperature=temperature, top_k=top_k,
                                        eos_id=tokenizer.eos_id, generator=generator).cpu()
        dt = time.perf_counter() - t0
        print(tokenizer.decode(out[0].numpy()), file=text_out)
        n_new = out.shape[1] - prompt_len
        print(f"Time for inference {i + 1}: {dt:.02f} sec total, {n_new / dt:.02f} tokens/sec",
              file=log_out)

    from ..utils.profiling import device_memory_stats

    peak = device_memory_stats(device)["peak_bytes_in_use"]
    if peak:
        print(f"Memory used: {peak / 2**30:.02f} GB", file=log_out)


def cli(args=None) -> None:
    """The command line: ``main``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(main, args)


if __name__ == "__main__":
    cli()
