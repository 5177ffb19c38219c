"""KV-cached inference engine (counterpart of
``fastmax_tpu/inference/engine.py``): one prefill (chunked past
``PREFILL_CHUNK`` tokens), then one single-token forward per new token,
greedy or sampled (temperature, top-k) from an explicit ``torch.Generator``.

The decode loop keeps the token buffer and the sampling on the device and
reads nothing back per token when ``eos_id`` is None: the host learns the
result once, at the end. With an ``eos_id`` it checks the new token each
step, as the reference's eos test does.

With a linear ``attn_alg`` (fastmax, fastmax_cuda, linearmax, performer) the
cache is the O(1) running state (``gpt.init_linear_cache``): the prompt is
prefilled exactly, in one pass (never in chunks: the state must absorb the
whole prompt at once), and each decode step advances the state through
``gpt.forward_linear_cache``, as the reference's engine does.

With a ``mesh`` (``parallel/sharding.make_mesh``) every rank of the mesh
builds the engine and calls ``generate`` with the same arguments (SPMD, one
process per rank): the gate+up fusion and the weights mode resolve on the
whole tree, then each rank keeps its shard (``prepare_sharded``) and a cache
of its query groups (``kv_cache_specs``). The reference skips the fusion for
sharded arrays, since a colwise cut of ``[fc_1 | fc_2]`` would put all of
``fc_1`` on the first rank; the port cuts the fused ``fc_12`` by halves
instead, so each rank holds ``[its fc_1 columns | its fc_2 columns]`` and its
MLP is one matmul, on K8 or K9 where the whole model's is. The batch is split over data x fsdp where
it divides, and the generated rows are gathered at the end. The sampled
tokens are broadcast from the first rank that shares the rows, so that a
near-tie can never split the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import gpt
from ..models.config import Config
from ..ops import quant
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


WEIGHTS_MODES = ("auto", "quantized", "preload", "preload_int8", "preload_int4",
                 "preload_int4_block")
# leaves whose arrays concatenate along the output axis; the codebook is shared
_FUSABLE_AXES = ("kernel", "q8", "scale8", "q4", "absmax", "bias")


def _fuse_mlp_gates(params: dict) -> dict:
    """Concatenate the SwiGLU gate+up linears ([fc_1 | fc_2] along the output
    axis) into one ``fc_12`` matmul, as the reference does: dense kernels,
    int8 (``q8``/``scale8``), 4-bit (``q4``/``absmax``, one shared ``code``)
    and biases. Skipped when the two differ in their leaves or carry others:
    double-quantized scales (``absmax_q``: their flat blocks do not
    concatenate along the output axis), LoRA or adapter terms, and the
    tiled int4 formats (a q4r1/q4b tree arrives with ``fc_12`` fused)."""
    blocks = params.get("blocks")
    mlp = blocks.get("mlp") if isinstance(blocks, dict) else None
    if not isinstance(mlp, dict) or "fc_1" not in mlp or "fc_2" not in mlp:
        return params
    fc1, fc2 = mlp["fc_1"], mlp["fc_2"]
    if set(fc1) != set(fc2) or any(k != "code" and k not in _FUSABLE_AXES for k in fc1):
        return params
    fused = {k: torch.cat([fc1[k], fc2[k]], dim=-1) for k in fc1 if k != "code"}
    if "code" in fc1:
        fused["code"] = fc1["code"]
    new_mlp = {k: v for k, v in mlp.items() if k not in ("fc_1", "fc_2")}
    new_mlp["fc_12"] = fused
    return {**params, "blocks": {**blocks, "mlp": new_mlp}}


def _leaf_names(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _largest_q4(params: dict) -> Optional[dict]:
    """The largest 4-bit linear of the tree (its first layer when stacked,
    without its bias), for autotuning."""
    best, best_size = None, -1

    def walk(node):
        nonlocal best, best_size
        if "q4" in node:
            arr = node["q4"]
            if arr.numel() > best_size:
                idx = (0,) * (arr.dim() - 2)
                best = {k: v[idx] if v.dim() > quant._RANK.get(k, 0) else v
                        for k, v in node.items() if k != "bias"}
                best_size = arr.numel()
            return
        for v in node.values():
            if isinstance(v, dict):
                walk(v)

    walk(params)
    return best


class InferenceEngine:
    """Config + params + cache shape for a fixed (batch, max_seq)."""

    # prompts longer than this prefill in PREFILL_CHUNK-token pieces, each of
    # which stays inside the int4 kernel's row cap (m <= 512)
    PREFILL_CHUNK = 512

    def __init__(self, cfg: Config, params: dict, *, max_seq_length: Optional[int] = None,
                 batch_size: int = 1, cache_dtype=None, weights_mode: str = "auto",
                 device=None, mesh=None):
        """weights_mode, for quantized params (the reference's):
        "quantized"     keep the packed weights; a 4-bit linear dequantizes
                        inside its matmul (K8 or dequantize + matmul, picked
                        by ``quant.autotune_quant_backend`` on the card);
        "preload"       dequantize once to the activation dtype;
        "preload_int8"  re-represent 4-bit linears as per-channel int8;
        "preload_int4"  re-represent 4-bit and int8 linears as rank-1 tiled
                        int4 (K1);
        "preload_int4_block" the same with per-64-block scales (K9);
        "auto"          int8 and tiled int4 stay as they are; packed 4-bit
                        takes the reference's chip branch, "preload_int4".
        The params are moved to ``device`` first, so the conversions and
        the autotune run there. ``mesh``: see the module's docstring; params
        are the whole tree, or a rank's ``ShardedParams``."""
        self.cfg = cfg
        self.device = default_device(device)
        self._linear_alg = cfg.attn_alg in gpt.LINEAR_ALGS
        self.mesh = mesh
        self.shard = None
        self.batch_size = batch_size
        self.local_batch = batch_size
        if mesh is None:
            self.params = self.prepare_params(_to_device(params, self.device), weights_mode)
        else:
            self.params, self.shard = self.prepare_sharded(cfg, params, mesh, weights_mode,
                                                           self.device)
            n = mesh.shape["data"] * mesh.shape["fsdp"]
            if n > 1 and batch_size % n == 0:
                self.local_batch = batch_size // n
        self.max_seq_length = min(max_seq_length or cfg.block_size, cfg.block_size)
        self.cache_dtype = cache_dtype or self.params["wte"].dtype
        self.rope_cache = build_rope_cache(self.max_seq_length, cfg.rope_n_elem, cfg.rope_base,
                                           cfg.rope_condense_ratio, device=self.device)

    @staticmethod
    def prepare_sharded(cfg: Config, params: dict, mesh, mode: str, device):
        """(local params, ShardPlan) of this rank: the serving layout (fused
        gate+up) and the weights mode resolved on the whole tree, then cut
        (``fc_12`` by halves)."""
        from ..parallel import sharding

        if not isinstance(mesh, sharding.Mesh):
            raise TypeError(f"mesh: a parallel.sharding.Mesh (make_mesh), not "
                            f"{type(mesh).__name__}")
        plan = getattr(params, "plan", None)  # a ShardedParams is cut already
        params = _to_device(params, device)
        if plan is None:
            local = sharding.shard_params(InferenceEngine.prepare_params(params, mode), mesh, cfg)
            return dict(local), local.plan
        return params, plan

    @staticmethod
    def prepare_params(params: dict, mode: str) -> dict:
        """The serving layout (fused gate+up) first, then the weights mode,
        so that the re-representations cover the fused ``fc_12`` too."""
        return InferenceEngine._resolve_weights(_fuse_mlp_gates(params), mode)

    @staticmethod
    def _resolve_weights(params: dict, mode: str) -> dict:
        if mode not in WEIGHTS_MODES:
            raise ValueError(f"unknown weights_mode {mode!r}; expected one of {WEIGHTS_MODES}")
        names = {n[-1] for n in _leaf_names(params)}
        has_q4 = any("q4" in n for n in names)
        has_q8 = any("q8" in n for n in names)
        if not (has_q4 or has_q8) or mode == "quantized":
            sample = _largest_q4(params) if has_q4 else None
            if sample is not None and sample["q4"].is_cuda:
                # pick the faster 4-bit route on this card, as the reference on its chip
                x = torch.zeros((1, sample["q4"].shape[0] * 2), dtype=params["wte"].dtype,
                                device=sample["q4"].device)
                quant.autotune_quant_backend(sample, x)
            return params
        if mode == "preload":
            return quant.dequantize_model(params, params["wte"].dtype)
        if mode == "preload_int8":
            return quant.requantize_int8_model(params)
        if mode == "preload_int4":
            return quant.requantize_int4_model(params, "rank1")
        if mode == "preload_int4_block":
            return quant.requantize_int4_model(params, "block")
        # auto: int8 and tiled int4 weights are the fast paths and stay; packed
        # 4-bit takes the reference's chip branch (rank-1 int4) on every device,
        # as the card plays the TPU's part (ROADMAP.md C: the reference picks
        # int8 off its chip when that fits)
        if not has_q4 or names & {"q4r1", "q4b"}:
            return params
        return quant.requantize_int4_model(params, "rank1")

    def new_cache(self) -> dict:
        """The KV cache, or for a linear arm the running state."""
        if self._linear_alg:
            return gpt.init_linear_cache(self.cfg, self.local_batch, device=self.device)
        groups = None if self.shard is None else self.shard.local_groups(self.cfg)
        return gpt.init_kv_cache(self.cfg, self.local_batch, self.max_seq_length,
                                 self.cache_dtype, device=self.device, n_groups=groups)

    # ---------------------------------------------------------------- the mesh

    @property
    def _split_batch(self) -> bool:
        return self.local_batch != self.batch_size

    def _agree(self, tokens: torch.Tensor) -> torch.Tensor:
        """The sampled tokens of the first rank that holds these rows, on every
        rank that holds them."""
        if self.mesh is None:
            return tokens
        from ..parallel import collectives as col

        tokens = tokens.to(torch.int32).contiguous()
        if self._split_batch:
            return col.broadcast(tokens, self.mesh.model_ranks[0], self.mesh.group("model"))
        return col.broadcast(tokens, 0, self.mesh.world)

    def _all_done(self, done: torch.Tensor) -> bool:
        """Whether every row of every rank has finished (the ranks' loops stay
        in step: the fsdp gathers and the sums are collectives)."""
        if not self._split_batch:
            return bool(done.all())
        from ..parallel import collectives as col

        return col.all_true(bool(done.all()), self.mesh.batch_group, self.mesh.comm_device)

    def _rows(self, prompt: torch.Tensor) -> torch.Tensor:
        if not self._split_batch:
            return prompt
        i = self.mesh.batch_ranks.index(self.mesh.rank)
        return prompt[i * self.local_batch:(i + 1) * self.local_batch]

    def _forward(self, tokens, cache, input_pos: int, plain: bool = False,
                 is_prefill: Optional[bool] = None):
        if self._linear_alg:
            return gpt.forward_linear_cache(self.params, self.cfg, tokens, state=cache,
                                            input_pos=input_pos, rope_cache=self.rope_cache,
                                            is_prefill=is_prefill, plain=plain, shard=self.shard)
        return gpt.forward(self.params, self.cfg, tokens, input_pos=input_pos, kv_cache=cache,
                           rope_cache=self.rope_cache, plain=plain, shard=self.shard)

    @torch.inference_mode()
    def prefill(self, prompt: torch.Tensor, cache: dict, plain: bool = False):
        """Run the (B, T) prompt through the model in PREFILL_CHUNK pieces (a
        linear arm: in one pass); returns (last-position logits (B, V), cache)."""
        if self._linear_alg:
            logits, cache = self._forward(prompt, cache, 0, plain, is_prefill=True)
            return logits[:, -1, :], cache
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
               top_k: Optional[int] = None, generator: Optional[torch.Generator] = None,
               plain: bool = False):
        """Decode from ``first_token`` (B,) until ``max_new`` tokens (first
        included) or, with ``eos_id``, until every row has emitted it; greedy
        at temperature 0, else sampled (see ``ops.sampling.sample``); ``plain``
        sends every kernel call to its plain version. Returns ((B, n)
        generated tokens on the device, cache)."""
        b = first_token.shape[0]
        max_new = max(max_new, 1)
        tokens = torch.zeros((b, max_new), dtype=torch.int32, device=self.device)
        tokens[:, 0] = first_token
        done = first_token == eos_id if eos_id is not None else None
        n = 1
        while n < max_new:
            if done is not None and self._all_done(done):
                break
            logits, cache = self._forward(tokens[:, n - 1:n], cache, prompt_len + n - 1, plain)
            nxt = self._agree(sample(logits[:, -1, :], temperature, top_k, generator=generator))
            tokens[:, n] = nxt
            if done is not None:
                done = done | (nxt == eos_id)
            n += 1
        return tokens[:, :n], cache

    def generate(self, prompt: torch.Tensor, max_returned_tokens: int, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 plain: bool = False) -> torch.Tensor:
        """Generation, greedy at temperature 0 (the default), else sampled
        with the top_k most likely tokens and noise from ``generator`` (the
        JAX engine's ``key``; None draws from PyTorch's default generator).
        prompt: (T,) or (B, T) token ids; ``plain`` as ``decode``'s. Returns
        the (B, n) sequence including the prompt, truncated at eos for batch 1
        (on a mesh: on every rank, every row)."""
        prompt = torch.as_tensor(prompt, device=self.device).to(torch.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        b, t = prompt.shape
        if b != self.batch_size:
            raise ValueError(f"batch {b} != engine batch_size {self.batch_size}")
        if max_returned_tokens > self.max_seq_length:
            raise ValueError(f"max_returned_tokens {max_returned_tokens} > max_seq_length "
                             f"{self.max_seq_length}")
        rows = self._rows(prompt)
        logits, cache = self.prefill(rows, self.new_cache(), plain)
        first = self._agree(sample(logits, temperature, top_k, generator=generator))
        gen, _ = self.decode(cache, first, t, max_returned_tokens - t, eos_id,
                             temperature=temperature, top_k=top_k, generator=generator,
                             plain=plain)
        out = torch.cat([rows, gen], dim=1)
        if self._split_batch:
            from ..parallel import collectives as col

            out = col.all_gather(out, 0, self.mesh.batch_group)
        if eos_id is not None and b == 1:
            hits = (out[0, t:] == eos_id).nonzero()
            if hits.numel():
                out = out[:, : t + int(hits[0, 0]) + 1]
        return out
