"""Pipeline-parallel training (counterpart of
``fastmax_tpu/parallel/pipeline.py``): GPipe's schedule, M micro-batches
flowing through P stages over a mesh axis.

Each rank of ``axis`` is a stage: it holds layers [s*L/P, (s+1)*L/P) of the
stacked blocks (``pp_param_specs`` names the cut, ``local_params`` takes a
rank's share of a whole tree); ``wte``, ``ln_f`` and ``lm_head`` are whole on
every rank. The reference runs the schedule as one SPMD program, a scan over
M + P - 1 ticks with one ``ppermute`` a tick, and leaves the backward to AD.
Here each rank runs the same ticks:

* stage 0 embeds micro-batch min(tk, M - 1); every other stage takes what it
  received;
* each stage runs its layers through ``gpt.apply_block`` under
  ``gpt._remat_wrap``, the no-cache forward's block and remat, so its
  attention is the trainable kernels' route (K4/K5 for the fastmax arms,
  K6/K7 for quadratic attention at T >= 1024);
* the last stage adds the loss of micro-batch tk - (P - 1) once
  tk >= P - 1;
* the activations go one stage on with ``collectives.ring_shift``, whose
  backward sends the gradient one stage back: the backward walks the ticks
  in reverse, the transpose of the forward, as XLA's is.

The loss is the sum over ``axis`` divided by M, the whole loss on every
rank. Every rank issues the same collectives in the same order, forward and
backward (under gloo a shift is an all-gather, so every rank takes part in
every tick's). So no rank drops a shift's output from its graph: stage 0
keeps what it received beside its embedding with a zero gradient (as the
reference's ``jnp.where`` does), and every rank keeps its last tick's output
beside its loss, so that each backward runs every tick's shift back in the
same order. What is skipped is compute alone: the embedding off stage 0, the
head off the last stage.

The gradients: each stage's block gradients are its own. ``wte``'s comes
from stage 0 alone and ``lm_head``'s and ``ln_f``'s from the last stage, so
``sync_pp_grads`` sums the leaves outside ``blocks`` over ``axis`` (the
transpose of the reference's replicated inputs); the data-axis ranks compute
the same thing and are not summed. With ``fsdp_specs``
(``pp_fsdp_param_specs``) the blocks are also split over ``fsdp`` and
gathered at stage entry; the fsdp peers then compute the same loss, which
counts 1 / fsdp of the gradient on each (the gather's reduce-scatter sums
them).

    step = make_pp_train_step(cfg, mesh, optimizer, axis="model", n_micro=4)
    params = local_params(params, mesh, pp_param_specs(cfg, params, axis="model"))
    params, opt_state, loss = step(params, opt_state, batch)  # batch (B, T+1)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import gpt
from ..models.config import Config
from ..ops.linear import embedding, linear
from ..ops.norms import apply_norm
from ..ops.rope import build_rope_cache
from ..training.step import tree_leaves
from ..utils.loss import cross_entropy
from . import collectives as col
from .sharding import LeafSplit, _lookup, _walk, gather_fsdp_local, local_slice, tree_paths


def pp_param_specs(cfg: Config, params: dict, *, axis: str = "model") -> dict:
    """The spec of each leaf (a tuple naming the mesh axis of each dim):
    every leaf under ``blocks`` splits its leading (n_layer,) axis over
    ``axis``; wte/ln_f/lm_head are whole (the empty spec)."""

    def walk(node, under_blocks):
        if isinstance(node, dict):
            return {k: walk(v, under_blocks or k == "blocks") for k, v in node.items()}
        return (axis,) + (None,) * (len(node.shape) - 1) if under_blocks else ()

    return {k: walk(v, k == "blocks") for k, v in params.items()}


def pp_fsdp_param_specs(cfg: Config, params: dict, *, axis: str = "model",
                        fsdp_axis: str = "fsdp", fsdp_size: int = 1) -> dict:
    """Pipeline x ZeRO-3: the blocks split their leading layer axis over
    ``axis`` and their largest free dim that ``fsdp_size`` divides over
    ``fsdp_axis``; the other leaves are whole. Pass the result to
    ``local_params`` and as ``make_pp_loss_fn(fsdp_specs=...)``."""

    def walk(node, under_blocks):
        if isinstance(node, dict):
            return {k: walk(v, under_blocks or k == "blocks") for k, v in node.items()}
        if not under_blocks:
            return ()
        spec = [axis] + [None] * (len(node.shape) - 1)
        if fsdp_size > 1:
            best, size = None, 0
            for i in range(1, len(node.shape)):
                if node.shape[i] % fsdp_size == 0 and node.shape[i] > size:
                    best, size = i, node.shape[i]
            if best is not None:
                spec[best] = fsdp_axis
        return tuple(spec)

    return {k: walk(v, k == "blocks") for k, v in params.items()}


def pp_in_specs(axis: str) -> dict:
    """The specs of the tree's top-level keys: blocks stage-split, the rest
    whole (the reference's ``shard_map`` in_specs prefix)."""
    return {"wte": (), "blocks": (axis,), "ln_f": (), "lm_head": ()}


def local_params(params: dict, mesh, specs: dict) -> dict:
    """This rank's block of each leaf of the whole tree ``params`` laid out by
    ``specs`` on ``mesh``: fresh tensors, so the whole tree can go."""
    return _walk(params, lambda path, x: x[local_slice(
        _lookup(specs, path), tuple(x.shape), mesh)].detach().clone())


def pp_leaf_splits(params: dict, mesh, specs: dict) -> list:
    """The ``LeafSplit`` of each local leaf (``tree_leaves`` order) under
    ``specs``, for the optimizers: the global norm and Adafactor's statistics
    are the whole tree's."""
    out = []
    for path, x in zip(tree_paths(params), tree_leaves(params)):
        spec = _lookup(specs, path)
        dims = {d: name for d, name in enumerate(spec) if name is not None}
        whole = [n * (mesh.shape[dims[d]] if d in dims else 1) for d, n in enumerate(x.shape)]
        out.append(LeafSplit(mesh, tuple(whole), dims))
    return out


def sync_pp_grads(params: dict, grads: list, mesh, *, axis: str = "model",
                  fsdp_specs: Optional[dict] = None, fsdp_axis: str = "fsdp") -> list:
    """The gradients of a rank's local leaves (``tree_leaves`` order; None
    where a stage never touched the leaf) made whole for its share: the
    leaves outside ``blocks`` summed over ``axis``; with ``fsdp_specs``,
    every leaf that is not split over fsdp also summed over ``fsdp_axis``
    (each fsdp peer holds 1 / fsdp of it)."""
    out = []
    for path, x, g in zip(tree_paths(params), tree_leaves(params), grads):
        g = torch.zeros_like(x) if g is None else g
        if path[0] != "blocks":
            g = col.all_reduce(g, mesh.group(axis))
        if fsdp_specs is not None and fsdp_axis not in _lookup(fsdp_specs, path):
            g = col.all_reduce(g, mesh.group(fsdp_axis))
        out.append(g)
    return out


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.like = (b.shape, b.dtype, b.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _keep(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (forward); ``b`` stays in the graph with a zero gradient, so
    that the collective that made ``b`` runs its backward on this rank too."""
    return _Keep.apply(a, b)


def make_pp_loss_fn(
    cfg: Config,
    mesh,
    *,
    axis: str = "model",
    n_micro: int = 4,
    remat=True,
    max_seq_length: Optional[int] = None,
    fsdp_specs: Optional[dict] = None,
    fsdp_axis: str = "fsdp",
):
    """The pipeline-parallel LM loss over (B, T+1) batches: ``loss_fn(params,
    batch)`` with ``params`` the rank's local tree (``local_params``) and
    ``batch`` the whole batch on every rank. B must divide by ``n_micro`` and
    cfg.n_layer by the ``axis`` size. The loss is the mean of the
    micro-batches' mean losses (the dense loss: the schedule only reorders
    the compute), its value the same on every rank, its gradient the rank's
    share (``sync_pp_grads`` makes it whole). ``fsdp_specs`` (from
    ``pp_fsdp_param_specs``): the blocks arrive split over ``fsdp_axis`` too
    and are gathered at stage entry."""
    p_size = mesh.shape[axis]
    if cfg.n_layer % p_size != 0:
        raise ValueError(f"n_layer={cfg.n_layer} must divide by pipeline stages {p_size}")
    n_local = cfg.n_layer // p_size
    group = mesh.group(axis)
    stage, last = mesh.coords[axis], p_size - 1
    fsdp = 1 if fsdp_specs is None else mesh.shape[fsdp_axis]
    n_rope = max_seq_length or cfg.block_size
    ropes = {}

    def embed(params, ids):
        x = embedding(params["wte"], ids)
        return x * (cfg.n_embd ** 0.5) if cfg.scale_embeddings else x

    def head_loss(params, y, targets):
        h = apply_norm(y, params["ln_f"], cfg.norm_class_name, cfg.norm_eps,
                       cfg.add_unit_offset)
        return cross_entropy(linear(params["lm_head"], h), targets)

    def loss_fn(params, batch):
        b = batch.shape[0]
        if b % n_micro != 0:
            raise ValueError(f"batch {b} must divide by n_micro={n_micro}")
        inputs = batch[:, :-1].reshape(n_micro, b // n_micro, -1)
        targets = batch[:, 1:].reshape(n_micro, b // n_micro, -1)
        m, mb, t = inputs.shape
        dev = batch.device
        if dev not in ropes:
            ropes[dev] = build_rope_cache(n_rope, cfg.rope_n_elem, cfg.rope_base,
                                          cfg.rope_condense_ratio, device=dev)
        cos, sin = ropes[dev][0][:t], ropes[dev][1][:t]
        if fsdp_specs is not None:
            params = gather_fsdp_local(params, fsdp_specs, mesh.group(fsdp_axis), fsdp_axis)

        def attn_fn(ap, n1):
            return gpt.apply_attn_nocache(ap, n1, cfg, cos, sin)

        def body(bp):
            return lambda h: gpt.apply_block(bp, h, cfg, None, attn_fn)

        steps = [gpt._remat_wrap(body(bp), remat)
                 for bp in gpt._unstack(params["blocks"], n_local)]
        recv = torch.zeros((mb, t, cfg.n_embd), dtype=params["wte"].dtype, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for tk in range(m + p_size - 1):
            x = _keep(embed(params, inputs[min(tk, m - 1)]), recv) if stage == 0 else recv
            for step in steps:
                x = step(x)
            if stage == last and tk >= last:
                loss_sum = loss_sum + head_loss(params, x, targets[tk - last])
            recv = col.ring_shift(x, group)
        loss = col.reduce_g(_keep(loss_sum, x), group) / m
        # the fsdp peers computed the same loss: each counts 1 / fsdp of its gradient
        return col.scale_grad(loss, 1.0 / fsdp)

    return loss_fn


def make_pp_train_step(
    cfg: Config,
    mesh,
    optimizer,
    *,
    axis: str = "model",
    n_micro: int = 4,
    remat=True,
    max_seq_length: Optional[int] = None,
):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on a
    rank's stage tree (``local_params`` of ``pp_param_specs``): the pipeline
    loss, its gradients made whole for the rank's share (``sync_pp_grads``),
    one update of ``optimizer`` (one of ``training/step.py``'s, its global
    norm the whole tree's), in place."""
    loss_fn = make_pp_loss_fn(cfg, mesh, axis=axis, n_micro=n_micro, remat=remat,
                              max_seq_length=max_seq_length)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        grads = sync_pp_grads(params, [p.grad for p in leaves], mesh, axis=axis)
        splits = pp_leaf_splits(params, mesh, pp_param_specs(cfg, params, axis=axis))
        optimizer.update(params, grads, opt_state, splits)
        return params, opt_state, loss.detach()

    return train_step
