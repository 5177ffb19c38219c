"""Sequence-parallel training (counterpart of
``fastmax_tpu/parallel/sequence_parallel.py``): the forward with the sequence
split over a mesh axis.

Every part of the transformer but attention is pointwise over the sequence,
so on a rank's chunk of positions it runs as it is; attention becomes ring
attention (``ring_attention.py``), the K/V chunks going round the axis's
ranks. RoPE and the causal mask take each chunk's global offset (its rank
on the axis times the chunk's length). The reference runs the body under
``shard_map``; here each rank runs it on its chunk and the loss's sums and
count are summed over the axis. The gradients: each rank's backward gives
its chunk's share of the whole gradient, which ``make_sp_train_step`` sums
over the axis (the transpose of the reference's replicated parameters).

    step = make_sp_train_step(cfg, mesh, optimizer, axis="model")
    params, opt_state, loss = step(params, opt_state, batch)  # batch (B, T+1)

``make_sp_tp_fsdp_loss_fn`` composes the three: the ring over ``data``,
Megatron's split over ``model`` and ZeRO-3 over ``fsdp``
(``parallel/sharding.py``'s training plan).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models import gpt
from ..models.config import Config
from ..ops.attention import repeat_kv_heads
from ..ops.linear import embedding
from ..ops.norms import apply_norm
from ..ops.rope import build_rope_cache
from ..training.step import tree_leaves
from . import collectives as col
from .ring_attention import ring_attention_local


def _rank_in(group) -> int:
    return 0 if group is None else dist.get_group_rank(group, dist.get_rank())


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sp_attn(p, x, cfg: Config, cos, sin, group, shard=None):
    """Attention over a local sequence chunk through the K/V ring; ``shard``:
    the query groups are the rank's share over ``model`` (summed after the
    projection)."""
    b, t, _ = x.shape
    hs = cfg.head_size
    q, k, v = gpt._project_qkv(p, x if shard is None else shard.enter(x, "attn"), cfg, cos,
                               sin, None, False)
    k, v = repeat_kv_heads(k, q.shape[1]), repeat_kv_heads(v, q.shape[1])
    y = ring_attention_local(q, k, v, group, scale=1.0 / hs ** 0.5)
    return gpt._finish_attn(p, y, x, q, cfg, b, t, hs, None, False, shard)


def sp_forward_local(params, cfg: Config, idx_local, rope_cache, group, shard=None):
    """The body each rank of ``group`` runs: idx_local (B, T/P), its chunk of
    the sequence; returns the chunk's logits (B, T/P, padded_vocab).
    ``shard``: ``params`` is the rank's tree of a training plan (``model``
    and ``fsdp`` splits)."""
    t_local = idx_local.shape[1]
    offset = _rank_in(group) * t_local
    cos = rope_cache[0][offset:offset + t_local]
    sin = rope_cache[1][offset:offset + t_local]
    top = params if shard is None else shard.top(params, ("wte", "ln_f"))
    x = embedding(top["wte"], idx_local)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)

    def attn_fn(ap, n1):
        return _sp_attn(ap, n1, cfg, cos, sin, group, shard)

    layers = [lambda bp=bp: bp for bp in gpt._unstack(params["blocks"], cfg.n_layer)] \
        if shard is None else shard.layers(params["blocks"], cfg.n_layer)
    for get in layers:
        x = gpt.apply_block(get(), x, cfg, None, attn_fn, shard=shard)
    x = apply_norm(x, top["ln_f"], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)
    return gpt.lm_head_fn(params, shard)(x)


def _check_attn_alg(cfg: Config) -> None:
    if cfg.attn_alg != "quadratic":
        raise ValueError(
            f"sequence-parallel mode implements softmax (quadratic) attention; "
            f"cfg.attn_alg={cfg.attn_alg!r}. The linear attention algorithms "
            "shard over sequence through their associative scan instead "
            "(ops/fastmax.py) — train them with the standard sharded step.")


def _rope(cfg: Config, max_seq_length: Optional[int], device):
    n = max_seq_length or cfg.block_size
    return build_rope_cache(n, cfg.rope_n_elem, cfg.rope_base, cfg.rope_condense_ratio,
                            device=device)


def _chunk(tokens: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    if tokens.shape[1] % n:
        raise ValueError(f"sequence length {tokens.shape[1]} must divide over {n} ranks")
    return tokens.chunk(n, dim=1)[_rank_in(group)]


def make_sp_forward(cfg: Config, mesh, *, axis: str = "model",
                    max_seq_length: Optional[int] = None):
    """(params, idx (B, T)) -> the whole logits (B, T, padded_vocab) on every
    rank, each rank running its chunk of T over ``axis``."""
    _check_attn_alg(cfg)
    group = mesh.group(axis)
    cache = {}

    def fn(params, idx):
        if idx.device not in cache:
            cache[idx.device] = _rope(cfg, max_seq_length, idx.device)
        out = sp_forward_local(params, cfg, _chunk(idx, group), cache[idx.device], group)
        return col.gather_slice(out, 1, group)

    return fn


def _sp_loss_parts(logits, tokens_local, group):
    """(sum of the NLL, count) of a chunk's logits against the stream shifted
    by one: the chunk's last position predicts the next rank's first token
    (one rank to the right), and the global last token has no target."""
    p_size, idx = _size(group), _rank_in(group)
    first = tokens_local[:, :1]
    next_first = col.shift(first, group, -1)  # rank i gets rank i + 1's
    targets = torch.cat([tokens_local[:, 1:], next_first], dim=1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    t_local = tokens_local.shape[1]
    pos = torch.arange(t_local, device=logits.device)[None, :]
    valid = pos < t_local - 1 if idx == p_size - 1 else torch.ones_like(pos, dtype=torch.bool)
    total = torch.sum(torch.where(valid, nll, 0.0))
    count = torch.sum(valid.float()) * tokens_local.shape[0]
    return total, count


def make_sp_loss_fn(cfg: Config, mesh, *, axis: str = "model",
                    max_seq_length: Optional[int] = None):
    """The sequence-parallel LM loss over (B, T+1) batches (the whole batch on
    every rank of ``axis``): the first T tokens are the stream, each rank
    takes its chunk of it (the (T+1)th token is dropped, as the reference
    drops it). The loss's value is the whole stream's on every rank; its
    gradient on a rank is that rank's share of the whole gradient."""
    _check_attn_alg(cfg)
    group = mesh.group(axis)
    cache = {}

    def loss_fn(params, batch):
        tokens = _chunk(batch[:, :-1], group)
        if tokens.device not in cache:
            cache[tokens.device] = _rope(cfg, max_seq_length, tokens.device)
        logits = sp_forward_local(params, cfg, tokens, cache[tokens.device], group)
        total, count = _sp_loss_parts(logits, tokens, group)
        n = col.all_reduce(count.detach().clone(), group)
        return col.reduce_g(total / n, group)

    return loss_fn


def make_sp_tp_fsdp_loss_fn(cfg: Config, mesh, host_params: dict, *, seq_axis: str = "data",
                            tp_axis: str = "model", fsdp_axis: str = "fsdp",
                            max_seq_length: Optional[int] = None):
    """The three-way parallel LM loss: sequence parallelism (the ring over
    ``seq_axis``) x Megatron's tensor parallelism (QKV/fc colwise, proj
    rowwise, over ``tp_axis``) x ZeRO-3 (each leaf also split over
    ``fsdp_axis`` and gathered before use). Returns (loss_fn, specs):
    ``specs`` is the cut in the reference's spec form (``layout_specs``);
    ``loss_fn(params, batch)`` takes the rank's tree,
    ``shard_params(host_params, mesh, cfg, train=True)``, and the whole (B,
    T+1) batch. Its value is the whole loss on every rank; the ranks' gradients
    summed over ``seq_axis`` x ``fsdp_axis`` (``ShardPlan.sync_grads``) are the
    whole gradient (the fsdp ranks see the same tokens: each backward counts
    1 / fsdp of it)."""
    from . import sharding as sh

    _check_attn_alg(cfg)
    if (seq_axis, fsdp_axis, tp_axis) != sh.AXES:
        raise ValueError(f"the port's mesh axes are {sh.AXES} (sequence, fsdp, model)")
    tp = mesh.shape[tp_axis]
    if cfg.n_query_groups % tp or cfg.padded_vocab_size % tp:
        raise ValueError("n_query_groups and vocab must divide tp size")
    fsdp = mesh.shape[fsdp_axis]
    specs = sh.layout_specs(cfg, host_params, tp=tp, fsdp_size=fsdp)
    group = mesh.group(seq_axis)
    cache = {}

    def loss_fn(params, batch):
        plan = params.plan
        tokens = _chunk(batch[:, :-1], group)
        if tokens.device not in cache:
            cache[tokens.device] = _rope(cfg, max_seq_length, tokens.device)
        logits = sp_forward_local(params, cfg, tokens, cache[tokens.device], group, plan)
        total, count = _sp_loss_parts(logits, tokens, group)
        n = col.all_reduce(count.detach().clone(), group)
        loss = col.reduce_g(total / n, group)
        return col.scale_grad(loss, 1.0 / fsdp)

    return loss_fn, specs


def make_sp_train_step(cfg: Config, mesh, optimizer, *, axis: str = "model",
                       max_seq_length: Optional[int] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` with
    ``params`` whole on every rank of ``axis``: the sequence-parallel loss,
    its gradients summed over ``axis``, one update of ``optimizer`` (one of
    ``training/step.py``'s), in place."""
    loss_fn = make_sp_loss_fn(cfg, mesh, axis=axis, max_seq_length=max_seq_length)
    group = mesh.group(axis)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        optimizer.update(params, [col.all_reduce(p.grad, group) for p in leaves], opt_state)
        return params, opt_state, loss.detach()

    return train_step
