"""Driver entry points of the port (counterpart of the repository's
``__graft_entry__.py``).

``entry(device=None) -> (fn, (params, idx))``: one forward of the flagship
model (TinyLlama-1.1B's architecture, GQA + RMSNorm + SwiGLU, cut to 4
layers) in bf16 on the card: ``fn(params, idx)`` gives the logits.

``dryrun_multichip(n_devices, device=None, backend=None)``: n ranks
(``collectives.spawn_local``) on an n-rank (data, fsdp, model) mesh, factored
as the reference factors its devices, run the reference's eight parallel
modes on tiny shapes, each held against the unsharded loss of the same
parameters and batch (relative 2e-3, finite) or, for the int4 decode, the
unsharded engine's greedy tokens:

1. the dp/fsdp/tp AdamW step (``shard_params(train=True)``);
2. sp: ``make_sp_loss_fn`` (ring attention over ``model``);
3. pp: ``make_pp_loss_fn`` (GPipe over ``model``, 2 micro-batches);
4. ep: a MoE of max(2 * model, 2) experts split over ``model``;
5. hybrid: ``make_hybrid_mesh`` on two simulated granules, its placement
   asserted (data >= 2);
6. fsdp x tp x sp: ``make_sp_tp_fsdp_loss_fn`` (data > 1, model > 1);
7. pp + fsdp: ``pp_fsdp_param_specs`` (model > 1, fsdp > 1);
8. tp int4 decode: NF4 in the "quantized" weights mode through the meshed
   ``InferenceEngine``, the 4-bit backend set to "pallas" so that the
   eligible linears run K8 (its plain version on the CPU).

The model is the reference's dry-run configuration (2 layers, 8 heads, 4
query groups, RMSNorm, SwiGLU, vocabulary 256) at 512 wide with an MLP of
1024 instead of 128 and 256: at the reference's width no linear of the tp 2
cut has the shape K8 takes (k % 512 == 0, n % 256 == 0: the reference's B7
condition), so its int4 decode would never reach the kernel.

The ranks run on the card, one each where the host has a card a rank (NCCL),
several on a card with ``backend="gloo"``; ``device="cpu"`` runs gloo ranks on
the CPU. Without CUDA and without ``device="cpu"`` it raises: it does not
fall back to the CPU (the reference's ``_ensure_devices`` is not ported).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .models.config import Config

FLAGSHIP = dict(name="tiny-llama-flagship", block_size=256, vocab_size=32000,
                padded_vocab_size=32000, n_layer=4, n_head=32, n_embd=2048, n_query_groups=4,
                rotary_percentage=1.0, parallel_residual=False, bias=False,
                _norm_class="RMSNorm", _mlp_class="LLaMAMLP", intermediate_size=5632)
DRYRUN = dict(name="dryrun", block_size=64, vocab_size=256, padded_vocab_size=256, n_layer=2,
              n_head=8, n_embd=512, n_query_groups=4, rotary_percentage=1.0,
              parallel_residual=False, bias=False, _norm_class="RMSNorm",
              _mlp_class="LLaMAMLP", intermediate_size=1024)
DRYRUN_MOE = dict(DRYRUN, name="dryrun-moe", _mlp_class="LLaMAMoE", intermediate_size=128,
                  n_expert_per_token=2)
PARITY_TOL = 2e-3


def _flagship_config() -> Config:
    return Config(**FLAGSHIP)


def entry(device=None):
    """``(fn, (params, idx))``: the flagship's random bf16 weights (seed 0) and
    a (1, 32) batch of token ids on ``device`` (default: the card);
    ``fn(params, idx)`` returns the (1, 32, 32000) logits."""
    from .inference.engine import default_device
    from .models import gpt

    cfg = _flagship_config()
    dev = default_device(device)
    params = gpt.init_params(cfg, 0, torch.bfloat16, dev)

    def fwd(params, idx):
        logits, _ = gpt.forward(params, cfg, idx)
        return logits

    idx = torch.as_tensor(np.random.default_rng(0).integers(0, 32000, (1, 32)), device=dev)
    return fwd, (params, idx)


def mesh_factors(n_devices: int) -> tuple:
    """(data, fsdp, model) of n ranks, as the reference factors its devices:
    model 2 where n is even, then fsdp 2 where the rest is, the rest data."""
    model = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // model
    fsdp = 2 if rest % 2 == 0 else 1
    return rest // fsdp, fsdp, model


def _fresh(tree: dict) -> dict:
    return {k: _fresh(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _tokens(seed: int, shape: tuple, device) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, shape), device=device)


def _value_and_grad(loss_fn, params: dict, batch) -> float:
    """The loss of ``params`` on ``batch`` after its backward (the reference's
    ``value_and_grad``: every mode runs its backward's collectives too)."""
    from .training.step import tree_leaves

    for x in tree_leaves(params):
        x.requires_grad_(x.is_floating_point())
    loss = loss_fn(params, batch)
    loss.backward()
    return float(loss.detach())


def _dryrun_rank(n_devices: int, device: Optional[str], backend: str) -> dict:
    """One rank of the dry run: every mode in the reference's order (every
    rank takes the same branches, so the collectives line up). Returns the
    printed lines and each mode's numbers, and this rank's kernel launches
    (over the run, and over mode 8's sharded decode)."""
    import torch.distributed as dist

    from .inference.engine import InferenceEngine
    from .kernels import build
    from .models import gpt
    from .ops import quant
    from .parallel import pipeline as pp
    from .parallel.sequence_parallel import make_sp_loss_fn, make_sp_tp_fsdp_loss_fn
    from .parallel.sharding import (MODEL_AXIS, assert_hybrid_placement, make_hybrid_mesh,
                                    make_mesh, shard_params)
    from .training.step import AdamW, make_loss_fn, make_train_step, tree_leaves

    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    build.reset_launch_counts()
    lines, modes = [], {}

    def check(name: str, got: float, ref: float, tol: float = PARITY_TOL) -> None:
        delta = abs(got - ref) / max(abs(ref), 1e-6)
        assert math.isfinite(got), f"{name}: non-finite loss {got}"
        assert delta < tol, (f"{name}: |loss-ref|/ref = {delta:.2e} >= {tol} "
                             f"(loss={got:.6f}, ref={ref:.6f})")
        lines.append(f"  parity {name}: loss={got:.6f} ref={ref:.6f} rel-delta={delta:.2e} < {tol}")
        modes[name] = {"loss": got, "ref": ref, "rel": delta}

    n = n_devices
    data, fsdp, model = mesh_factors(n)
    mesh = make_mesh(data, fsdp, model)
    cfg = Config(**DRYRUN)
    host = gpt.init_params(cfg, 0, torch.float32, dev)

    def ref(c, params, batch):
        with torch.no_grad():
            return float(make_loss_fn(c, remat=False)(params, batch))

    # 1. dp/fsdp/tp: one AdamW step; its loss is the one before the update
    optimizer = AdamW(lambda count: 1e-3)
    batch = _tokens(0, (data * fsdp * 2, 33), dev)
    ref_loss = ref(cfg, host, batch)
    local = shard_params(_fresh(host), mesh, cfg, tp=model > 1, train=True)
    state = optimizer.init(local, local.plan.leaf_splits(tree_leaves(local)))
    _, _, loss = make_train_step(cfg, optimizer, remat=True, shard=local.plan)(local, state, batch)
    lines.append(f"dryrun_multichip: mesh(data={data}, fsdp={fsdp}, model={model}) "
                 f"[{n} ranks over {backend} on {dev.type}]")
    check("dp/fsdp/tp", float(loss), ref_loss)
    del local, state

    # 2. sp: the sequence-parallel loss (ring attention) over the model axis
    if model > 1:
        sp_batch = _tokens(1, (2, 32 * model + 1), dev)
        check(f"sp (ring attention x{model})",
              _value_and_grad(make_sp_loss_fn(cfg, mesh, axis="model"), _fresh(host), sp_batch),
              ref(cfg, host, sp_batch))

    # 3. pp: GPipe over the model axis, two micro-batches
    if model > 1 and cfg.n_layer % model == 0:
        pp_batch = _tokens(2, (2, 33), dev)
        pp_local = pp.local_params(host, mesh, pp.pp_param_specs(cfg, host, axis="model"))
        check(f"pp ({model} stages x 2 micro)",
              _value_and_grad(pp.make_pp_loss_fn(cfg, mesh, axis="model", n_micro=2), pp_local,
                              pp_batch),
              ref(cfg, host, pp_batch))

    # 4. ep: the experts split over the model axis
    moe_cfg = Config(**DRYRUN_MOE, n_expert=max(2 * model, 2))
    moe_host = gpt.init_params(moe_cfg, 1, torch.float32, dev)
    moe_local = shard_params(_fresh(moe_host), mesh, moe_cfg, tp=model > 1, train=True)
    plan = moe_local.plan
    moe_loss = make_loss_fn(moe_cfg, remat=True, shard=plan)
    check(f"ep ({moe_cfg.n_expert} experts)",
          _value_and_grad(lambda p, b: moe_loss(p, plan.batch_rows(b)), moe_local, batch),
          ref(moe_cfg, moe_host, batch))
    del moe_local, moe_host

    # 5. hybrid: the data axis across two simulated granules, fsdp and model inside one
    if data >= 2 and n % 2 == 0:
        gsize = n // 2
        hmesh = make_hybrid_mesh(data=2, fsdp=fsdp, model=gsize // fsdp, granule_size=gsize)
        assert_hybrid_placement(hmesh, granule_size=gsize)
        h_local = shard_params(_fresh(host), hmesh, cfg, tp=hmesh.shape[MODEL_AXIS] > 1,
                               train=True)
        h_state = optimizer.init(h_local, h_local.plan.leaf_splits(tree_leaves(h_local)))
        _, _, h_loss = make_train_step(cfg, optimizer, remat=True, shard=h_local.plan)(
            h_local, h_state, batch)
        check("hybrid (2 granules: data/DCN x fsdp,model/ICI)", float(h_loss), ref_loss)
        del h_local, h_state

    # 6. fsdp x tp x sp: the ring over data, tp over model, every leaf split over fsdp
    if data > 1 and model > 1:
        c_loss_fn, _ = make_sp_tp_fsdp_loss_fn(cfg, mesh, host, seq_axis="data",
                                               tp_axis="model", fsdp_axis="fsdp")
        c_batch = _tokens(3, (2, 32 * data + 1), dev)
        check(f"fsdp x tp x sp (seq/{data} x tp/{model} x fsdp/{fsdp})",
              _value_and_grad(c_loss_fn, shard_params(_fresh(host), mesh, cfg, train=True),
                              c_batch),
              ref(cfg, host, c_batch))

    # 7. pp + fsdp: the stage-split blocks also split over fsdp
    if model > 1 and fsdp > 1 and cfg.n_layer % model == 0:
        pf_specs = pp.pp_fsdp_param_specs(cfg, host, axis="model", fsdp_axis="fsdp",
                                          fsdp_size=fsdp)
        pf_batch = _tokens(4, (2, 33), dev)
        pf_loss_fn = pp.make_pp_loss_fn(cfg, mesh, axis="model", n_micro=2, fsdp_specs=pf_specs,
                                        fsdp_axis="fsdp")
        check(f"pp+fsdp ({model} stages x fsdp/{fsdp})",
              _value_and_grad(pf_loss_fn, pp.local_params(host, mesh, pf_specs), pf_batch),
              ref(cfg, host, pf_batch))

    # 8. tp decode of NF4 weights split over the model axis: the unsharded engine's tokens
    if model > 1:
        q_host = quant.quantize_model(host, "bnb.nf4")
        ref_engine = InferenceEngine(cfg, q_host, max_seq_length=48, batch_size=1,
                                     weights_mode="quantized", device=dev)
        tp_engine = InferenceEngine(cfg, q_host, max_seq_length=48, batch_size=1,
                                    weights_mode="quantized", device=dev, mesh=mesh)
        prompt = _tokens(5, (12,), dev)
        backend_was = quant.get_quant_backend()
        quant.set_quant_backend("pallas")
        try:
            ref_tokens = ref_engine.generate(prompt, 24).cpu().numpy()
            before = build.launch_counts()
            tp_tokens = tp_engine.generate(prompt, 24).cpu().numpy()
            after = build.launch_counts()
        finally:
            quant.set_quant_backend(backend_was)
        assert tp_tokens.shape == ref_tokens.shape and (tp_tokens == ref_tokens).all(), (
            f"tp int4 decode diverged:\n  tp={tp_tokens}\n  ref={ref_tokens}")
        lines.append(f"  parity tp int4 decode (tp/{model} x fsdp/{fsdp}): "
                     f"{tp_tokens.shape[1] - 12} greedy tokens identical")
        modes["tp int4 decode"] = {
            "tokens": tp_tokens.tolist(),
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
    lines.append("dryrun_multichip ok: all modes match the unsharded reference loss")
    return {"lines": lines, "modes": modes, "mesh": (data, fsdp, model),
            "launches": {k: v for k, v in build.launch_counts().items() if v}}


def dryrun_multichip(n_devices: int, device=None, backend: Optional[str] = None) -> dict:
    """The eight-mode dry run on ``n_devices`` fresh ranks (see the module
    doc): prints rank 0's parity lines and returns {"mesh", "modes",
    "lines", "launches": each rank's kernel launches}. Raises if a mode
    disagrees or a rank fails."""
    from .parallel import collectives as col

    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the dry run on "
                           "the CPU (gloo ranks)")
    backend = backend or ("gloo" if on_cpu else "nccl")
    if backend == "nccl" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} NCCL ranks need a card each; this host has "
                           f"{torch.cuda.device_count()}: pass backend='gloo' to put several "
                           "ranks on a card")
    ranks = col.spawn_local(_dryrun_rank, n_devices, backend,
                            args=(n_devices, "cpu" if on_cpu else None, backend),
                            timeout=900)
    report = dict(ranks[0])
    for line in report["lines"]:
        print(line)
    report["launches"] = [r["launches"] for r in ranks]
    return report
