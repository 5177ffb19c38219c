"""Bodies that run on every rank of a mesh and return what the sharded
serving and training paths computed, for a caller to hold against one rank
or against the reference: ``run_cases`` is the target of
``collectives.spawn_local`` in the CPU tests (gloo ranks), and
``chip_smoke.py``'s phase 18 calls the command-line and loader bodies on the
card. Each case builds its own mesh over the whole group (the serving
bodies (world // (tp * fsdp), fsdp, tp), the training bodies the (dp, fsdp,
tp) they are given), so one group runs every case; rank 0 returns the result
and the other ranks None. Inputs are plain: a config's
fields, numpy parameter trees, token lists, command-line flags.

The spawned ranks import this module by name, so it imports no jax and
nothing of the JAX package: only ``fastmax_tpu_torch``.
"""

from __future__ import annotations

import builtins
import contextlib
import io
import json
import time
import urllib.request
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.parallel import collectives as col
from fastmax_tpu_torch.parallel.sharding import (assert_hybrid_placement, gather_fsdp_local,
                                                 local_slice, make_hybrid_mesh, make_mesh,
                                                 shard_params)


def _mesh(tp: int, fsdp: int):
    return make_mesh(dist.get_world_size() // (tp * fsdp), fsdp, tp)


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch split over data x fsdp (all of them when
    the split does not divide the batch)."""
    n = mesh.shape["data"] * mesh.shape["fsdp"]
    if n == 1 or x.shape[0] % n:
        return x
    i = mesh.batch_ranks.index(mesh.rank)
    step = x.shape[0] // n
    return x[i * step:(i + 1) * step]


def forward(cfg: dict, params: dict, idx, tp: int, fsdp: int, device="cpu"):
    """The no-cache forward of ``params`` cut on a (., fsdp, tp) mesh, the
    batch split over data x fsdp; the (B, T, V) logits, gathered."""
    cfg = Config(**cfg)
    mesh = _mesh(tp, fsdp)
    local = shard_params(from_numpy_params(params, device), mesh, cfg)
    idx = torch.as_tensor(np.asarray(idx), device=device)
    rows = _rows(idx, mesh)
    with torch.inference_mode():
        out, _ = gpt.forward(dict(local), cfg, rows, shard=local.plan)
    if rows.shape[0] != idx.shape[0]:
        out = col.all_gather(out, 0, mesh.batch_group)
    return {"logits": out.float().cpu().numpy(), "kept_whole": list(local.plan.kept_whole)} \
        if mesh.leader else None


def engine(cfg: dict, params: dict, prompt, n_ret: int, tp: int, fsdp: int,
           cache_dtype: str = "float32", weights_mode: str = "auto", device="cpu"):
    """``InferenceEngine(mesh=...)``'s greedy tokens, and the shapes of this
    rank's fresh cache (every rank's, gathered)."""
    from fastmax_tpu_torch.inference.engine import InferenceEngine

    cfg = Config(**cfg)
    mesh = _mesh(tp, fsdp)
    prompt = np.asarray(prompt)
    eng = InferenceEngine(cfg, from_numpy_params(params, device), max_seq_length=n_ret + 8,
                          batch_size=1 if prompt.ndim == 1 else prompt.shape[0],
                          cache_dtype=getattr(torch, cache_dtype), weights_mode=weights_mode,
                          device=device, mesh=mesh)
    out = eng.generate(torch.as_tensor(prompt), n_ret)
    shapes = {k: list(v.shape) for k, v in eng.new_cache().items()}
    coords = [None] * dist.get_world_size()
    dist.all_gather_object(coords, (mesh.coords, shapes))
    return {"tokens": out.cpu().numpy(), "caches": coords,
            "kept_whole": list(eng.shard.kept_whole)} if mesh.leader else None


def batcher(cfg: dict, params: dict, prompts: list, n_new: int, tp: int, fsdp: int = 1,
            kw: Optional[dict] = None, prefix: Optional[list] = None, device="cpu"):
    """``ContinuousBatcher(mesh=...)``: rank 0 submits the greedy prompts
    (after registering ``prefix`` in the prefix cache, if given), runs them to
    completion and closes; the others follow. Rank 0's {"tokens": per
    prompt, "stats"}."""
    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher

    cfg = Config(**cfg)
    mesh = _mesh(tp, fsdp)
    b = ContinuousBatcher(cfg, from_numpy_params(params, device), device=device, mesh=mesh,
                          **(kw or {}))
    if not mesh.leader:
        b.follow()
        return None
    if prefix is not None:
        b.register_prefix(np.asarray(prefix, np.int32))
    rids = [b.submit(np.asarray(p, np.int32), n_new) for p in prompts]
    res = b.run_to_completion()
    b.close()
    return {"tokens": [res[r] for r in rids],
            "stats": {"prefix_cache_hits": b.prefix_cache_hits, "spec_drafted": b.spec_drafted,
                      "spec_accepted": b.spec_accepted,
                      "kept_whole": list(b.shard.kept_whole)}}


def generate_cli(flags: list):
    """``generate.cli(flags)`` on every rank; rank 0's printed text."""
    from fastmax_tpu_torch.inference import generate

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        generate.cli(flags)
    return out.getvalue() if dist.get_rank() == 0 else None


def chat_cli(flags: list, prompts: list):
    """``chat.cli(flags)`` on every rank; rank 0 reads ``prompts`` and then an
    empty line as its input, which ends every rank's session. Rank 0's
    printed text."""
    from fastmax_tpu_torch.inference import chat

    out = io.StringIO()
    lines = iter(list(prompts) + [""])
    real_input = builtins.input
    if dist.get_rank() == 0:
        builtins.input = lambda prompt="": next(lines)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            chat.cli(flags)
    finally:
        builtins.input = real_input
    return out.getvalue() if dist.get_rank() == 0 else None


def post(port: int, body: dict, timeout: float = 300.0) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def server_cli(flags: list, bodies: list):
    """``server.cli(flags)`` on every rank; rank 0's server answers
    ``bodies`` over 127.0.0.1, then stops as on Ctrl-C (which ends the
    followers). Rank 0's answers."""
    from fastmax_tpu_torch.inference import server

    if dist.get_rank() != 0:
        server.cli(flags)
        return None
    made, answers = [], []
    real_server, real_sleep = server.Server, time.sleep

    class Recording(real_server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def sleep(s):
        if s != 3600:  # the scheduler thread's idle wait
            return real_sleep(s)
        for body in bodies:
            answers.append(post(made[0].port, body))
        raise KeyboardInterrupt

    server.Server, time.sleep = Recording, sleep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            server.cli(flags)
    finally:
        server.Server, time.sleep = real_server, real_sleep
    return answers


def sharded_load(checkpoint_dir: str, tp: int, fsdp: int, idx, dtype: str = "float32",
                 device="cpu"):
    """``load_sharded_model_params`` on a (., fsdp, tp) mesh against the same
    cut of the whole load (``shard_params`` of ``load_model_params``): the
    largest difference over every leaf, the leaf paths, the bytes this rank
    read, and the logits of the sharded forward on ``idx``."""
    from fastmax_tpu_torch.utils import sharded_load as sl
    from fastmax_tpu_torch.utils.checkpoint import load_model_params

    mesh = _mesh(tp, fsdp)
    sl.READ_BYTES[0] = 0
    cfg, got = sl.load_sharded_model_params(checkpoint_dir, mesh, dtype=getattr(torch, dtype),
                                            device=device)
    read = sl.READ_BYTES[0]
    _, whole = load_model_params(checkpoint_dir, cfg, getattr(torch, dtype), device)
    want = shard_params(whole, mesh, cfg)
    diffs = {}

    def walk(a, b, path):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + (k,))
            else:
                assert a[k].shape == b[k].shape, (path + (k,), a[k].shape, b[k].shape)
                diffs[".".join(path + (k,))] = float((a[k].float() - b[k].float()).abs().max())

    walk(dict(got), dict(want), ())
    rows = _rows(torch.as_tensor(np.asarray(idx), device=device), mesh)
    with torch.inference_mode():
        out, _ = gpt.forward(dict(got), cfg, rows, shard=got.plan)
    out = col.all_gather(out, 0, mesh.batch_group) if rows.shape[0] != len(idx) else out
    reads = [None] * dist.get_world_size()
    dist.all_gather_object(reads, read)
    experts = None
    if "experts" in got["blocks"]["mlp"]:
        ex = got["blocks"]["mlp"]["experts"]["fc_1"]["kernel"]
        experts = col.all_gather(ex, 1, mesh.group("model")).cpu().numpy()
    return {"diffs": diffs, "read_bytes": reads, "logits": out.float().cpu().numpy(),
            "experts_fc_1": experts} if mesh.leader else None


def gather_roundtrip(x):
    """A leaf cut over fsdp (and one left whole) on a (., 2, 1) mesh, put back
    by ``gather_fsdp_local``: every rank's gathered leaves."""
    mesh = _mesh(1, 2)
    x = torch.as_tensor(np.asarray(x))
    specs = {"a": {"kernel": (None, "fsdp")}, "b": ()}
    local = {"a": {"kernel": x[local_slice(specs["a"]["kernel"], tuple(x.shape), mesh)]},
             "b": x[:, :4]}
    full = gather_fsdp_local(local, specs, mesh.group("fsdp"))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (full["a"]["kernel"].numpy(), full["b"].numpy()))
    return out if mesh.leader else None


def hybrid_mesh(data: int, fsdp: int, model: int, granule_size: int):
    """``make_hybrid_mesh`` over the group, its placement checked: every
    rank's (layout, coordinates)."""
    mesh = make_hybrid_mesh(data, fsdp, model, granule_size=granule_size)
    assert_hybrid_placement(mesh, granule_size=granule_size)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (mesh.layout, mesh.coords))
    return out if mesh.leader else None


# ------------------------------------------------------------------ training


def _register(entry: Optional[dict]) -> None:
    """Put a config into the port's registry in this rank's process (the
    trainers build models by name)."""
    if entry is None:
        return
    from fastmax_tpu_torch.models import config as config_mod

    reg = dict(config_mod.registry())
    reg[entry["name"]] = dict(entry)
    config_mod.registry = lambda reg=reg: reg


def _leader_out(mesh, value):
    return value if mesh.leader else None


def train_steps(cfg: dict, params: dict, batches: list, mesh: tuple, train: dict,
                remat=True, device="cpu"):
    """``make_train_step`` on the (dp, fsdp, tp) ``mesh``, one step a global
    batch of ``batches``: the losses and the whole parameters after them."""
    from fastmax_tpu_torch.training import fit
    from fastmax_tpu_torch.training.step import make_train_step, tree_leaves
    from fastmax_tpu_torch.utils.args import TrainArgs
    from fastmax_tpu_torch.models.weights import to_numpy_params

    cfg = Config(**cfg)
    m = make_mesh(*mesh)
    local = shard_params(from_numpy_params(params, device), m, cfg, train=True)
    opt = fit.build_optimizer(TrainArgs(**train))
    state = opt.init(local, local.plan.leaf_splits(tree_leaves(local)))
    step = make_train_step(cfg, opt, remat=remat, shard=local.plan)
    losses = [float(step(local, state, torch.as_tensor(np.asarray(b), device=device))[2])
              for b in batches]
    whole = fit.whole_params(local)
    return _leader_out(m, {"losses": losses, "params": to_numpy_params(whole),
                           "kept_whole": list(local.plan.kept_whole)})


def sft_grads(cfg: dict, params: dict, inputs, labels, mesh: tuple, trainable=None,
              device="cpu"):
    """``finetune.sft_loss_fn``'s loss over the global (inputs, labels) batch
    on the ``mesh`` and the whole gradient of each leaf (of the leaves
    ``trainable`` names, when given)."""
    from fastmax_tpu_torch.parallel.sharding import tree_paths
    from fastmax_tpu_torch.training.finetune import sft_loss_fn
    from fastmax_tpu_torch.training.step import tree_leaves

    cfg = Config(**cfg)
    m = make_mesh(*mesh)
    local = shard_params(from_numpy_params(params, device), m, cfg, train=True)
    plan = local.plan
    leaves = tree_leaves(local)
    names = [".".join(p) for p in tree_paths(local)]
    for name, x in zip(names, leaves):
        x.requires_grad_(x.is_floating_point() and (trainable is None or name in trainable))
    batch = tuple(torch.as_tensor(np.asarray(a), device=device) for a in (inputs, labels))
    loss = sft_loss_fn(cfg, shard=plan)(local, plan.batch_rows(batch))
    loss.backward()
    grads = plan.sync_grads(leaves, [x.grad for x in leaves])
    out = {}
    with torch.no_grad():
        for path, x, g in zip(plan.paths, leaves, grads):
            if g is not None:
                out[".".join(path)] = plan.leaf_split(path, x).gather(g).cpu().numpy()
    return _leader_out(m, {"loss": float(loss), "grads": out})


def _metrics(out) -> list:
    from pathlib import Path

    lines = (Path(out) / "metrics.csv").read_text().strip().splitlines()
    rows = [dict(zip(lines[0].split(","), r.split(","))) for r in lines[1:]]
    return [float(r["loss"]) for r in rows if r.get("loss")]


def pretrain_mesh(entry: dict, kw: dict, train: dict, out: str, data: str, mesh: tuple,
                  resume: bool = False, copy_state: Optional[str] = None):
    """``pretrain.setup`` at ``mesh`` = (dp, fsdp, tp) on the group: the logged
    losses, the step and the mesh's shapes (rank 0). ``copy_state``: rank 0
    copies the saved train state there afterwards."""
    import shutil

    from fastmax_tpu_torch.training import pretrain
    from fastmax_tpu_torch.utils.args import EvalArgs, IOArgs, TrainArgs

    _register(entry)
    dp, fsdp, tp = mesh
    state = pretrain.setup(model_name=entry["name"], dp=dp, fsdp=fsdp, tp=tp, **kw,
                           train=TrainArgs(**train), eval=EvalArgs(interval=1000, max_iters=1),
                           io=IOArgs(train_data_dir=data, out_dir=out, resume=resume),
                           device="cpu")
    if dist.get_rank() == 0 and copy_state:
        shutil.copytree(f"{out}/state", copy_state)
    dist.barrier()
    return {"losses": _metrics(out), "step": state.step} if dist.get_rank() == 0 else None


def finetune_mesh(entry: dict, kw: dict, train: dict, out: str, mesh: tuple):
    """``finetune.setup`` at ``mesh`` on the group: the logged losses and the
    names and shapes of the delta file rank 0 wrote."""
    from safetensors.numpy import load_file

    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.utils.args import EvalArgs, IOArgs, TrainArgs

    _register(entry)
    dp, fsdp, tp = mesh
    finetune.setup(model_name=entry["name"], dp=dp, fsdp=fsdp, tp=tp, **kw,
                   train=TrainArgs(**train), eval=EvalArgs(interval=1000, max_iters=1),
                   io=IOArgs(out_dir=out), device="cpu")
    dist.barrier()
    if dist.get_rank():
        return None
    delta = load_file(f"{out}/{kw['method']}_weights.safetensors")
    return {"losses": _metrics(out), "delta": {k: v for k, v in delta.items()}}


def bench_mesh(entry: dict, kw: dict):
    """``bench_mfu.run`` on the group (rank 0's result)."""
    from fastmax_tpu_torch.training import bench_mfu

    _register(entry)
    out = bench_mfu.run(model_name=entry["name"], **kw, device="cpu")
    return out if dist.get_rank() == 0 else None


def ring_case(q, k, v, mesh: tuple, axis: str = "model", grad_out=None):
    """``ring_attention_sharded`` on whole q, k, v at ``mesh``: the output and,
    with ``grad_out``, the gradients of <out, grad_out> by q, k and v."""
    from fastmax_tpu_torch.parallel.ring_attention import ring_attention_sharded

    m = make_mesh(*mesh)
    q, k, v = (torch.as_tensor(np.asarray(x)).requires_grad_(grad_out is not None)
               for x in (q, k, v))
    out = ring_attention_sharded(q, k, v, m, axis=axis)
    res = {"out": out.detach().numpy()}
    if grad_out is not None:
        (out * torch.as_tensor(np.asarray(grad_out))).sum().backward()
        # each rank's chunk of each gradient: summed, the whole one
        res.update({n: col.all_reduce(x.grad, m.group(axis)).numpy()
                    for n, x in (("dq", q), ("dk", k), ("dv", v))})
    return _leader_out(m, res)


def sp_case(cfg: dict, params: dict, batch, mesh: tuple, what: str, steps: int = 3,
            axis: str = "model"):
    """The sequence-parallel entries on ``mesh``: "forward" (the whole
    logits of ``make_sp_forward`` on batch[:, :-1]), "loss" (the loss and its
    gradients summed over the axis), "step" (the losses of ``steps``
    ``make_sp_train_step`` steps), "refuse" (the message a linear arm gets),
    "three_way" (``make_sp_tp_fsdp_loss_fn``'s loss and the whole gradients)."""
    from fastmax_tpu_torch.parallel import sequence_parallel as sp
    from fastmax_tpu_torch.training.step import AdamW, tree_leaves

    cfg = Config(**cfg)
    m = make_mesh(*mesh)
    whole = from_numpy_params(params, "cpu")
    batch = torch.as_tensor(np.asarray(batch))
    if what == "refuse":
        cfg.attn_alg = "fastmax"
        try:
            sp.make_sp_loss_fn(cfg, m, axis=axis)
        except ValueError as e:
            return _leader_out(m, str(e))
        raise AssertionError("the linear arm was not refused")
    if what == "forward":
        with torch.no_grad():
            out = sp.make_sp_forward(cfg, m, axis=axis)(whole, batch[:, :-1])
        return _leader_out(m, out.numpy())
    if what == "step":
        opt = AdamW(lambda c: 5e-3, weight_decay=1e-4)
        state = opt.init(whole)
        step = sp.make_sp_train_step(cfg, m, opt, axis=axis)
        return _leader_out(m, [float(step(whole, state, batch)[2]) for _ in range(steps)])
    if what == "loss":
        leaves = tree_leaves(whole)
        for x in leaves:
            x.requires_grad_(True)
        loss = sp.make_sp_loss_fn(cfg, m, axis=axis)(whole, batch)
        loss.backward()
        g = m.group(axis)
        from fastmax_tpu_torch.parallel.sharding import tree_paths

        grads = {".".join(p): col.all_reduce(x.grad, g).numpy()
                 for p, x in zip(tree_paths(whole), leaves)}
        return _leader_out(m, {"loss": float(loss), "grads": grads})
    # three_way: the ring over data, tp over model, fsdp
    loss_fn, specs = sp.make_sp_tp_fsdp_loss_fn(cfg, m, whole)
    local = shard_params(whole, m, cfg, train=True)
    leaves = tree_leaves(local)
    for x in leaves:
        x.requires_grad_(True)
    loss = loss_fn(local, batch)
    loss.backward()
    plan = local.plan
    grads = plan.sync_grads(leaves, [x.grad for x in leaves])
    with torch.no_grad():
        grads = {".".join(p): plan.leaf_split(p, x).gather(gr).numpy()
                 for p, x, gr in zip(plan.paths, leaves, grads)}
    return _leader_out(m, {"loss": float(loss), "grads": grads, "specs": specs})


def run_cases(cases: list) -> dict:
    """Run [(name, function name, kwargs), ...] of this module in order on
    this rank; {name: result}."""
    return {name: globals()[fn](**kw) for name, fn, kw in cases}


def _whole_pp_grads(local: dict, grads: list, specs: dict, mesh) -> dict:
    """Whole gradients from a stage's synced ones: each leaf gathered over the
    axes its spec names (the layer axis over ``model``, in stage order)."""
    from fastmax_tpu_torch.parallel.sharding import _lookup, tree_paths

    out = {}
    for path, g in zip(tree_paths(local), grads):
        for d, name in enumerate(_lookup(specs, path)):
            if name is not None:
                g = col.all_gather(g, d, mesh.group(name))
        out[".".join(path)] = g.float().numpy()
    return out


def pp_case(cfg: dict, params: dict, batch, mesh: tuple, what: str, n_micro: int = 2,
            steps: int = 3):
    """The pipeline entries on ``mesh``: "loss" (``make_pp_loss_fn``'s value),
    "grads" (its value and whole gradients, with every rank's gradients of
    the leaves outside ``blocks``), "fsdp" (the same through
    ``pp_fsdp_param_specs``), "step" (the losses of ``steps``
    ``make_pp_train_step`` steps of AdamW), "refuse" (the messages of an
    n_layer the stages do not divide and of a batch n_micro does not)."""
    from fastmax_tpu_torch.parallel import pipeline as pp
    from fastmax_tpu_torch.parallel.sharding import tree_paths
    from fastmax_tpu_torch.training.step import AdamW, tree_leaves

    m = make_mesh(*mesh)
    if what == "refuse":
        msgs = []
        try:
            pp.make_pp_loss_fn(Config(**{**cfg, "n_layer": 3}), m, n_micro=n_micro)
        except ValueError as e:
            msgs.append(str(e))
        fn = pp.make_pp_loss_fn(Config(**cfg), m, n_micro=n_micro + 1)
        try:
            fn(None, torch.zeros((n_micro * 2, 9), dtype=torch.int64))
        except ValueError as e:
            msgs.append(str(e))
        return _leader_out(m, msgs)
    cfg = Config(**cfg)
    whole = from_numpy_params(params, "cpu")
    batch = torch.as_tensor(np.asarray(batch))
    specs = pp.pp_fsdp_param_specs(cfg, whole, fsdp_size=m.shape["fsdp"]) if what == "fsdp" \
        else pp.pp_param_specs(cfg, whole)
    local = pp.local_params(whole, m, specs)
    if what == "step":
        opt = AdamW(lambda c: 5e-3, weight_decay=1e-4)
        state = opt.init(local)
        step = pp.make_pp_train_step(cfg, m, opt, n_micro=n_micro)
        return _leader_out(m, [float(step(local, state, batch)[2]) for _ in range(steps)])
    fsdp_specs = specs if what == "fsdp" else None
    loss_fn = pp.make_pp_loss_fn(cfg, m, n_micro=n_micro, fsdp_specs=fsdp_specs)
    if what == "loss":
        with torch.no_grad():
            return _leader_out(m, float(loss_fn(local, batch)))
    leaves = tree_leaves(local)
    for x in leaves:
        x.requires_grad_(True)
    loss = loss_fn(local, batch)
    loss.backward()
    grads = pp.sync_pp_grads(local, [x.grad for x in leaves], m, fsdp_specs=fsdp_specs)
    replicated = {".".join(p): g.numpy() for p, g in zip(tree_paths(local), grads)
                  if p[0] != "blocks"}
    whole_g = _whole_pp_grads(local, grads, specs, m)
    if not m.leader:
        return {"replicated": replicated}
    return {"loss": float(loss.detach()), "grads": whole_g, "replicated": replicated}
