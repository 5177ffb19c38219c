"""KV-cached inference engine (counterpart of
``fastmax_tpu/inference/engine.py``): one prefill (chunked past
``PREFILL_CHUNK`` tokens), then one single-token forward per new token,
greedy or sampled (temperature, top-k) from an explicit ``torch.Generator``.

The decode loop keeps the token buffer and the sampling on the device and
reads nothing back per token when ``eos_id`` is None: the host learns the
result once, at the end. With an ``eos_id`` it checks the new token each
step, as the reference's eos test does. The linear-attention state cache
comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import gpt
from ..models.config import Config
from ..ops.rope import build_rope_cache
from ..ops.sampling import sample


def default_device(device=None) -> torch.device:
    """The card unless the caller names another device; raises without CUDA."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _fuse_mlp_gates(params: dict) -> dict:
    """Concatenate the SwiGLU gate+up kernels ([fc_1 | fc_2] along the output
    axis) into one ``fc_12`` matmul, for dense ``kernel`` leaves. As in the
    reference, other formats are left as they are: a q4r1 tree arrives with
    ``fc_12`` already fused (InferenceEngine.prepare_params of the JAX
    package, or models/synthetic.py)."""
    blocks = params.get("blocks")
    mlp = blocks.get("mlp") if isinstance(blocks, dict) else None
    if not isinstance(mlp, dict) or "fc_1" not in mlp or "fc_2" not in mlp:
        return params
    fc1, fc2 = mlp["fc_1"], mlp["fc_2"]
    if set(fc1) != {"kernel"} or set(fc2) != {"kernel"}:
        return params
    new_mlp = {k: v for k, v in mlp.items() if k not in ("fc_1", "fc_2")}
    new_mlp["fc_12"] = {"kernel": torch.cat([fc1["kernel"], fc2["kernel"]], dim=-1)}
    return {**params, "blocks": {**blocks, "mlp": new_mlp}}


def _leaf_names(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, prefix + (k,))
        else:
            yield prefix + (k,)


class InferenceEngine:
    """Config + params + cache shape for a fixed (batch, max_seq)."""

    # prompts longer than this prefill in PREFILL_CHUNK-token pieces, each of
    # which stays inside the int4 kernel's row cap (m <= 512)
    PREFILL_CHUNK = 512

    def __init__(self, cfg: Config, params: dict, *, max_seq_length: Optional[int] = None,
                 batch_size: int = 1, cache_dtype=None, weights_mode: str = "auto",
                 device=None):
        """weights_mode: "quantized" and "auto" keep q4r1 and dense weights
        as they are; the re-representing modes of the reference ("preload",
        "preload_int8", "preload_int4", "preload_int4_block") are not ported
        yet."""
        self.cfg = cfg
        self.device = default_device(device)
        self.params = _to_device(self.prepare_params(params, weights_mode), self.device)
        self.max_seq_length = min(max_seq_length or cfg.block_size, cfg.block_size)
        self.batch_size = batch_size
        self.cache_dtype = cache_dtype or self.params["wte"].dtype
        self.rope_cache = build_rope_cache(self.max_seq_length, cfg.rope_n_elem, cfg.rope_base,
                                           cfg.rope_condense_ratio, device=self.device)

    @staticmethod
    def prepare_params(params: dict, mode: str) -> dict:
        if mode not in ("quantized", "auto"):
            raise NotImplementedError(
                f"weights_mode {mode!r} is not ported yet: it comes with the slice that ports "
                "the quantizers (ROADMAP.md queue A, item 3)")
        params = _fuse_mlp_gates(params)
        unported = [n for n in _leaf_names(params)
                    if n[-1] in ("q4", "q8", "q4b", "absmax", "lora_A", "adapter_scale")]
        if unported:
            raise NotImplementedError(
                f"weight formats of {'.'.join(unported[0])} are not ported yet (q4r1 and "
                "dense only)")
        return params

    def new_cache(self) -> dict:
        if self.cfg.attn_alg != "quadratic":
            raise NotImplementedError("the linear-attention state cache is not ported yet")
        return gpt.init_kv_cache(self.cfg, self.batch_size, self.max_seq_length,
                                 self.cache_dtype, device=self.device)

    def _forward(self, tokens, cache, input_pos: int, plain: bool = False):
        return gpt.forward(self.params, self.cfg, tokens, input_pos=input_pos, kv_cache=cache,
                           rope_cache=self.rope_cache, plain=plain)

    @torch.inference_mode()
    def prefill(self, prompt: torch.Tensor, cache: dict, plain: bool = False):
        """Run the (B, T) prompt through the model in PREFILL_CHUNK pieces;
        returns (last-position logits (B, V), cache)."""
        t = prompt.shape[1]
        c = self.PREFILL_CHUNK
        pos = 0
        while pos < t:
            step = min(c, t - pos)
            logits, cache = self._forward(prompt[:, pos:pos + step], cache, pos, plain)
            pos += step
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def decode(self, cache: dict, first_token: torch.Tensor, prompt_len: int, max_new: int,
               eos_id: Optional[int] = None, *, temperature: float = 0.0,
               top_k: Optional[int] = None, generator: Optional[torch.Generator] = None):
        """Decode from ``first_token`` (B,) until ``max_new`` tokens (first
        included) or, with ``eos_id``, until every row has emitted it; greedy
        at temperature 0, else sampled (see ``ops.sampling.sample``).
        Returns ((B, n) generated tokens on the device, cache)."""
        b = first_token.shape[0]
        max_new = max(max_new, 1)
        tokens = torch.zeros((b, max_new), dtype=torch.int32, device=self.device)
        tokens[:, 0] = first_token
        done = first_token == eos_id if eos_id is not None else None
        n = 1
        while n < max_new:
            if done is not None and bool(done.all()):
                break
            logits, cache = self._forward(tokens[:, n - 1:n], cache, prompt_len + n - 1)
            nxt = sample(logits[:, -1, :], temperature, top_k, generator=generator)
            tokens[:, n] = nxt
            if done is not None:
                done = done | (nxt == eos_id)
            n += 1
        return tokens[:, :n], cache

    def generate(self, prompt: torch.Tensor, max_returned_tokens: int, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Generation, greedy at temperature 0 (the default), else sampled
        with the top_k most likely tokens and noise from ``generator`` (the
        JAX engine's ``key``; None draws from PyTorch's default generator).
        prompt: (T,) or (B, T) token ids. Returns the (B, n) sequence
        including the prompt, truncated at eos for batch 1."""
        prompt = torch.as_tensor(prompt, device=self.device).to(torch.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        b, t = prompt.shape
        if b != self.batch_size:
            raise ValueError(f"batch {b} != engine batch_size {self.batch_size}")
        if max_returned_tokens > self.max_seq_length:
            raise ValueError(f"max_returned_tokens {max_returned_tokens} > max_seq_length "
                             f"{self.max_seq_length}")
        logits, cache = self.prefill(prompt, self.new_cache())
        first = sample(logits, temperature, top_k, generator=generator)
        gen, _ = self.decode(cache, first, t, max_returned_tokens - t, eos_id,
                             temperature=temperature, top_k=top_k, generator=generator)
        out = torch.cat([prompt, gen], dim=1)
        if eos_id is not None and b == 1:
            hits = (out[0, t:] == eos_id).nonzero()
            if hits.numel():
                out = out[:, : t + int(hits[0, 0]) + 1]
        return out
