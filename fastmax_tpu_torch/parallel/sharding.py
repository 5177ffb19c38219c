"""Mesh construction and parameter sharding (counterpart of
``fastmax_tpu/parallel/sharding.py``).

Mesh axes, as the reference's:
  data   replicas (the batch is split over it where it divides)
  fsdp   parameter sharding (ZeRO-3): each leaf is split on its largest free
         dim and gathered just before use; the batch is split here too
  model  tensor parallelism (megatron): QKV/fc colwise, proj rowwise

The one difference of design: the reference is a single controller that
annotates arrays with ``NamedSharding`` and leaves partitioning to GSPMD,
which inserts the collectives. The port runs one process per rank on
``torch.distributed``; each rank holds its own shards as plain tensors, so
that the hand-written kernels (K1, K2, K3, K8, K9) run on the rank's shard
as they are, and the collectives are written out (``collectives.py``). The
function computed is the same; the order of the rowwise sums is not.

* ``param_specs`` / ``sanitize_spec`` / ``kv_cache_specs`` keep the
  reference's rules and return, per leaf, a tuple naming the mesh axis of
  each dim (None: not split), as the reference's ``PartitionSpec``.
* ``shard_params`` cuts a rank's local tree from a whole one (or, through
  ``utils/sharded_load.py``, from a checkpoint on disk) and returns it with
  the ``ShardPlan`` that the forward (``models/gpt.py``) runs it by. Every
  leaf of a linear that runs along the split axis goes with it: scales,
  absmax blocks, the rank-1 envelopes and the tiles of the tiled int4
  formats, which are re-packed for the shard (the codes, and so the
  dequantized weights, are the whole matrix's). The fused QKV is split by
  query group; a fused ``fc_12`` by halves. A rowwise bias stays on the
  first model rank (zeros elsewhere: it is added once after the sum). MoE
  experts go over ``model`` on their expert axis.
* A linear whose format cannot be cut at this ``tp`` (a 4-bit row split
  off a 64-row block, double-quantized scales, LoRA or adapter leaves)
  stays whole, and with it the rest of its attention or MLP, which then runs
  unsplit on every rank; so does the attention of a model whose query
  groups ``tp`` does not divide (its cache is then replicated, as
  ``kv_cache_specs`` has it) and of the linear-attention arms (whose state
  the reference's batcher leaves replicated). ``ShardPlan.kept_whole`` names
  them.

Weights modes resolve on the whole tree before the split
(``InferenceEngine.prepare_sharded``): requantizing a shard is not the shard
of a requantized matrix.

Training (``shard_params(..., train=True)``) gives the plan its
differentiable mode: every collective of the forward is one of
``collectives``' autograd pairs, a colwise sub-block's entry sums its input's
gradient over ``model`` (Megatron's *f*), a rowwise bias is kept whole on
every model rank and added after the sum, and each layer's leaves are gathered
inside the layer's remat body, so a recompute gathers them again. The plan
then also knows what the optimizer and the fit loop need: each rank's rows of
a global micro-batch (``batch_rows``, the split of ``batch_spec``), the
gradient sums over data x fsdp (``sync_grads``), the masked mean over the
global batch (``global_mean``), and each leaf's split (``LeafSplit``): which
axes its gradient norm and its statistics are summed over, and how it is
gathered whole (saves) and cut again (a resume at another mesh).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import Config
from ..ops import quant
from . import collectives as col

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)


# ------------------------------------------------------------------ the mesh


class Mesh:
    """This rank's place on a (data, fsdp, model) mesh of ranks, with a
    process group for each axis and one for data x fsdp (the batch axis).
    ``layout`` is the (data, fsdp, model) array of global ranks."""

    def __init__(self, layout: np.ndarray, device_mesh=None):
        self.layout = np.asarray(layout)
        data, fsdp, model = self.layout.shape
        self.shape = {DATA_AXIS: data, FSDP_AXIS: fsdp, MODEL_AXIS: model}
        self.size = int(self.layout.size)
        self.rank = dist.get_rank()
        where = np.argwhere(self.layout == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not on the mesh {self.layout.tolist()}")
        self.coords = dict(zip(AXES, (int(c) for c in where[0])))
        self.device_mesh = device_mesh
        self.backend = dist.get_backend()
        # the plan and counts travel as int64 tensors on this device (NCCL needs the card)
        self.comm_device = torch.device("cuda", torch.cuda.current_device()) \
            if self.backend == "nccl" else torch.device("cpu")
        d, f, m = (self.coords[a] for a in AXES)
        self.model_ranks = [int(r) for r in self.layout[d, f, :]]
        self.fsdp_ranks = [int(r) for r in self.layout[d, :, m]]
        self.batch_ranks = [int(r) for r in self.layout[:, :, m].reshape(-1)]
        self.groups = {a: device_mesh.get_group(a) if device_mesh is not None else None
                       for a in AXES}
        # data x fsdp: every rank creates every group, in the same order
        self.batch_group = None
        if data * fsdp > 1:
            for mm in range(model):
                ranks = [int(r) for r in self.layout[:, :, mm].reshape(-1)]
                g = self.groups[FSDP_AXIS] if data == 1 else (
                    self.groups[DATA_AXIS] if fsdp == 1 else dist.new_group(ranks))
                if mm == m:
                    self.batch_group = g
        self.world = dist.group.WORLD
        self.agreed: dict = {}  # agree_once's choices

    def group(self, axis: str):
        return self.groups[axis]

    def agree_once(self, key, decide, options) -> str:
        """The choice ``decide()`` makes on global rank 0, on every rank, once
        a ``key`` (every rank asks for the same keys in the same order)."""
        if key not in self.agreed:
            self.agreed[key] = col.agree(decide() if self.rank == 0 else options[0], options,
                                         self.comm_device)
        return self.agreed[key]

    @property
    def leader(self) -> bool:
        """The rank that owns host decisions (rank 0 of the world)."""
        return self.rank == 0

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(data: int = 1, fsdp: int = 1, model: int = 1) -> Mesh:
    """The (data, fsdp, model) mesh over the ranks of the process group,
    row-major as the reference reshapes its device list, on
    ``init_device_mesh``. The group (``collectives.init_from_env`` or
    ``spawn_local``) must be up and hold exactly data * fsdp * model ranks;
    its backend is the caller's choice: NCCL where each rank has its own
    card (torchrun's default, ``collectives.init_from_env``), gloo on the
    CPU, or gloo passed explicitly for ranks that share a card."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks with torchrun "
                           "(collectives.init_from_env) or collectives.spawn_local")
    n = data * fsdp * model
    if n != dist.get_world_size():
        raise ValueError(f"mesh needs {n} ranks, the group has {dist.get_world_size()}")
    dm = init_device_mesh(_device_type(), (data, fsdp, model), mesh_dim_names=AXES)
    return Mesh(np.arange(n).reshape(data, fsdp, model), dm)


def mesh_from_env(tp: int = 1, fsdp: int = 1, module: str = "") -> Optional[Mesh]:
    """The mesh of a sharded entry point: None at tp * fsdp == 1, else the
    torchrun group joined (``collectives.require_ranks``: it raises, naming
    the torchrun line, when the process was started alone), the rank's card
    made current under NCCL, and make_mesh(world // (tp * fsdp), fsdp, tp):
    ranks beyond tp * fsdp form the data axis (replicas)."""
    n = tp * fsdp
    if n == 1:
        return None
    col.require_ranks(n, module)
    key = (tp, fsdp, dist.get_world_size())
    if key not in _ENV_MESHES:  # one mesh a process: the loader and the engine share it
        if dist.get_backend() == "nccl":
            torch.cuda.set_device(col.rank_device())
        _ENV_MESHES[key] = make_mesh(dist.get_world_size() // n, fsdp, tp)
    return _ENV_MESHES[key]


_ENV_MESHES: dict = {}


def train_mesh_from_env(dp: int = 1, fsdp: int = 1, tp: int = 1, module: str = "",
                        micro_batch: Optional[int] = None) -> Optional[Mesh]:
    """The (dp, fsdp, tp) mesh of a trainer: None at dp * fsdp * tp == 1 in a
    process with no group; else the torchrun group joined with the training
    timeout (started alone, it raises, naming the torchrun line), its world
    size checked against dp * fsdp * tp, the rank's card made current under
    NCCL. A group of one rank (a 1 x 1 x 1 mesh) goes through the collectives
    as any other. ``micro_batch`` must divide over dp * fsdp, as the
    reference requires."""
    n = dp * fsdp * tp
    if micro_batch is not None and micro_batch % (dp * fsdp):
        raise ValueError(f"micro_batch_size {micro_batch} must divide over dp*fsdp = "
                         f"{dp * fsdp} (the batch mesh axes)")
    if n == 1 and not dist.is_initialized():
        return None
    col.require_ranks(n, module, timeout=col.TRAINING_TIMEOUT, what="dp * fsdp * tp")
    if dist.get_world_size() != n:
        raise ValueError(f"dp * fsdp * tp = {n} must equal the world size "
                         f"{dist.get_world_size()}")
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(col.rank_device())
    return make_mesh(dp, fsdp, tp)


def granule_ids(ranks, granule_size: Optional[int] = None,
                local_world_size: Optional[int] = None) -> list:
    """The connectivity granule of each rank of ``ranks`` (in that order):
    ranks of one granule share fast links (NVLink inside a node); different
    granules talk over the network. A granule is a node, ``rank //
    LOCAL_WORLD_SIZE``; ``granule_size`` overrides it by position in the list
    (a simulated width, as the reference's for its virtual devices)."""
    out = []
    lws = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or None
    for i, r in enumerate(ranks):
        if granule_size:
            out.append(i // granule_size)
        elif lws:
            out.append(int(r) // lws)
        else:
            out.append(0)
    return out


def hybrid_layout(data: int = 1, fsdp: int = 1, model: int = 1, ranks=None,
                  granule_size: Optional[int] = None,
                  local_world_size: Optional[int] = None) -> np.ndarray:
    """The (data, fsdp, model) array of ranks of ``make_hybrid_mesh``: the
    data axis spans granules, fsdp and model stay inside one; a pure
    function of the rank list. Raises ValueError without ``data`` granules of
    ``fsdp * model`` ranks each."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    gids = granule_ids(ranks, granule_size, local_world_size)
    groups: dict = {}
    for r, g in zip(ranks, gids):
        groups.setdefault(g, []).append(r)
    ordered = sorted(groups)
    per = fsdp * model
    usable = [g for g in ordered if len(groups[g]) >= per]
    if len(usable) < data:
        raise ValueError(
            f"hybrid mesh needs {data} granules of >= {per} ranks; topology has "
            f"{[(g, len(groups[g])) for g in ordered]} (single-granule topologies should use "
            "make_mesh)")
    arr = np.empty((data, fsdp, model), dtype=np.int64)
    for i in range(data):
        arr[i] = np.asarray(groups[usable[i]][:per]).reshape(fsdp, model)
    return arr


def make_hybrid_mesh(data: int = 1, fsdp: int = 1, model: int = 1,
                     granule_size: Optional[int] = None) -> Mesh:
    """The granule-aware mesh (the reference's ``make_hybrid_mesh``, the role
    of ``FSDPStrategy(sharding_strategy="HYBRID_SHARD")``): pure-DP gradient
    traffic crosses granules, the per-layer gathers and the TP sums stay
    inside one. Check it with ``assert_hybrid_placement``."""
    from torch.distributed.device_mesh import DeviceMesh

    layout = hybrid_layout(data, fsdp, model, granule_size=granule_size)
    if layout.size != dist.get_world_size():
        raise ValueError(f"mesh needs {layout.size} ranks, the group has "
                         f"{dist.get_world_size()}")
    dm = DeviceMesh(_device_type(), torch.as_tensor(layout), mesh_dim_names=AXES)
    return Mesh(layout, dm)


def assert_hybrid_placement(mesh, granule_size: Optional[int] = None, all_ranks=None,
                            local_world_size: Optional[int] = None) -> None:
    """The hybrid invariant on a Mesh or a (data, fsdp, model) rank array:
    each data index lies inside one granule, and distinct data indices lie in
    distinct granules. ``granule_size``/``all_ranks`` as given to
    ``make_hybrid_mesh`` (simulated granules are positions in the full list)."""
    arr = np.asarray(getattr(mesh, "layout", mesh))
    if all_ranks is None:
        all_ranks = range(dist.get_world_size()) if dist.is_initialized() else \
            sorted(int(r) for r in arr.ravel())
    all_ranks = [int(r) for r in all_ranks]
    gid_of = dict(zip(all_ranks, granule_ids(all_ranks, granule_size, local_world_size)))
    seen = []
    for i in range(arr.shape[0]):
        gids = {gid_of[int(r)] for r in arr[i].ravel()}
        assert len(gids) == 1, (f"data index {i} spans granules {sorted(gids)} — fsdp/model "
                                "collectives would cross the network")
        seen.append(gids.pop())
    assert len(set(seen)) == arr.shape[0], f"data axis reuses granules: {seen}"


# ------------------------------------------------------- the reference's specs


def _fsdp_dim(spec: tuple, shape: tuple, fsdp_on: bool, divisor: int,
              skip: tuple = ()) -> tuple:
    """Add the fsdp axis to the largest still-unsharded, divisible dim."""
    if not fsdp_on:
        return spec
    best, best_size = None, 0
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and i not in skip and dim % divisor == 0 and dim > best_size:
            best, best_size = i, dim
    if best is None:
        return spec
    out = list(spec)
    out[best] = FSDP_AXIS
    return tuple(out)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: Config, params: dict, *, tp: bool = True, fsdp_size: int = 1) -> dict:
    """The reference's spec of each leaf: a tuple with, per dim, the mesh axis
    it is split over or None. tp=False gives pure FSDP/replicated layouts;
    fsdp_size > 1 adds the fsdp axis on every leaf's largest free dim. The
    leaves may be tensors or anything with a ``shape``."""
    fsdp_on = fsdp_size > 1

    def leaf_spec(path: tuple, leaf) -> tuple:
        shape = tuple(leaf.shape)
        name = path[-1]
        col = MODEL_AXIS if tp else None
        nd = len(shape)
        spec = [None] * nd
        if path[0] == "blocks":
            if "experts" in path:
                spec = [None, col] + [None] * (nd - 2)
            elif path[-2] == "attn" and name in ("kernel", "bias", "q4", "q8", "absmax"):
                spec = [None] * (nd - 1) + [col]
            elif path[-2] == "proj" and name in ("kernel", "q4", "q8", "absmax"):
                spec = [None, col] + [None] * (nd - 2)
            elif path[-2] in ("fc", "fc_1", "fc_2") and \
                    name in ("kernel", "bias", "q4", "q8", "absmax"):
                spec = [None] * (nd - 1) + [col]
        elif path[0] == "lm_head" and name in ("kernel", "q4", "q8"):
            spec = [None] * (nd - 1) + [col]
        return _fsdp_dim(tuple(spec), shape, fsdp_on, fsdp_size)

    return _walk(params, leaf_spec)


def sanitize_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop axis names whose mesh size does not divide the dim. ``mesh``: a
    Mesh or a dict of axis sizes."""
    sizes = getattr(mesh, "shape", mesh)
    out = []
    for d, names in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        group = names if isinstance(names, tuple) else (names,)
        size = 1
        for n in group:
            size *= sizes.get(n, 1)
        out.append(names if shape[d] % size == 0 else None)
    return tuple(out)


def kv_cache_specs(cfg: Config, *, tp: bool = True) -> dict:
    """Cache specs: batch over data+fsdp, query groups over model, for both
    layouts of ``gpt.init_kv_cache`` (k/v (L, B, G, S, hs); the int8 cache's
    k_scale/v_scale (L, B, G, S)). MQA (G == 1) keeps its one group whole."""
    group_axis = MODEL_AXIS if (tp and cfg.n_query_groups > 1) else None
    kv = (None, (DATA_AXIS, FSDP_AXIS), group_axis, None, None)
    scale = (None, (DATA_AXIS, FSDP_AXIS), group_axis, None)
    return {"k": kv, "v": kv, "k_scale": scale, "v_scale": scale}


def batch_spec() -> tuple:
    return ((DATA_AXIS, FSDP_AXIS),)


def local_slice(spec: tuple, shape: tuple, mesh) -> tuple:
    """The index (a tuple of slices) of this rank's block of a leaf laid out
    by the (sanitized) ``spec`` on ``mesh``: each named dim is cut into equal
    contiguous blocks in the order of its axes."""
    out = []
    for d, names in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(slice(None))
            continue
        group = names if isinstance(names, tuple) else (names,)
        idx, size = 0, 1
        for n in group:
            idx = idx * mesh.shape[n] + mesh.coords[n]
            size *= mesh.shape[n]
        step = shape[d] // size
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_kv_cache(cache: dict, mesh, cfg: Config, *, tp: bool = True) -> dict:
    """This rank's block of a whole KV cache, by ``kv_cache_specs``."""
    specs = kv_cache_specs(cfg, tp=tp)
    out = {}
    for k, v in cache.items():
        spec = sanitize_spec(specs[k], tuple(v.shape), mesh)
        out[k] = v[local_slice(spec, tuple(v.shape), mesh)].clone()
    return out


def gather_fsdp_local(params, specs, group, axis: str = FSDP_AXIS):
    """Undo the fsdp sharding of a tree of local shards: all-gather each
    leaf's fsdp-split dim over ``group`` (the reference's manual counterpart
    of GSPMD's per-layer all-gather), differentiably: a leaf's gradient is
    reduce-scattered back (``collectives.gather_scatter``), as the pipeline's
    stage entry needs."""
    def g(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        for d, names in enumerate(tuple(spec)):
            grp = names if isinstance(names, tuple) else (names,)
            if axis in grp:
                return col.gather_scatter(x, d, group)
        return x

    return _walk(params, g)


# --------------------------------------------------------------- the real split

_WEIGHT_KEYS = ("kernel", "q4", "q8", "q4r1", "q4b")
_COLWISE = ("attn", "fc", "fc_1", "fc_2", "fc_12")
_SPLITTABLE = {"kernel", "bias", "q8", "scale8", "q4", "absmax", "code", "q4r1", "u4", "v4",
               "q4b", "scale4", "n4", "k4"}


def _is_linear(node) -> bool:
    return isinstance(node, dict) and any(k in node for k in _WEIGHT_KEYS)


def linear_features(p: dict) -> tuple:
    """(in, out) features of one linear (of one layer, whatever its format)."""
    if "kernel" in p:
        return tuple(p["kernel"].shape[-2:])
    if "q8" in p:
        return tuple(p["q8"].shape[-2:])
    if "q4" in p:
        return p["q4"].shape[-2] * 2, p["q4"].shape[-1]
    if "q4r1" in p:
        return p["u4"].shape[-1], p["v4"].shape[-1]
    return p["k4"].shape[-2], p["n4"].shape[-2]


def _can_split(p: dict, role: str, tp: int, halves: bool = False) -> bool:
    """Whether a linear's format can be cut ``tp`` ways along its output
    (role "col"; ``halves``: each half of a fused pair) or input ("row")."""
    if set(p) - _SPLITTABLE:
        return False  # LoRA/adapter leaves, double-quantized scales
    k, n = linear_features(p)
    if role == "col":
        return (n // 2 if halves else n) % tp == 0 and (not halves or n % 2 == 0)
    if k % tp:
        return False
    if p.keys() & {"q4", "q4r1", "q4b"}:
        return (k // tp) % quant.DEFAULT_BLOCK == 0
    return True


def _narrow(x, dim: int, ranges) -> object:
    """``x`` cut to ``ranges`` ((start, length) pairs, concatenated) along ``dim``."""
    dim = dim % len(x.shape)
    if len(ranges) == 1:
        return x.narrow(dim, *ranges[0])
    return torch.cat([x.narrow(dim, s, n) for s, n in ranges], dim=dim)


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return x.zeros()


def _repack_tiled(p: dict, role: str, ranges) -> dict:
    """A tiled int4 linear (q4r1 or q4b, leading stack axes allowed) cut to
    ``ranges`` of its rows ("row") or columns ("col") and re-packed: the
    codes and scales are the whole matrix's, only the tiling is the shard's."""
    key = "q4r1" if "q4r1" in p else "q4b"
    lead = tuple(p[key].shape[:-4])
    k, n = linear_features(p)
    out: dict = {}
    blk = quant.DEFAULT_BLOCK

    def cut(a, dim, rs, scale=1):
        return _narrow(a, dim, [(s // scale, m // scale) for s, m in rs])

    for idx in np.ndindex(*lead) if lead else [()]:
        codes = quant._unpack_int4_tiled(p[key][idx])[:k, :n]
        codes = cut(codes, 0 if role == "row" else 1, ranges).to(torch.int32)
        part = {key: quant.pack_int4_tiled(codes)}
        if key == "q4r1":
            u, v = p["u4"][idx], p["v4"][idx]
            part["u4"] = cut(u, 0, ranges) if role == "row" else u.clone()
            part["v4"] = cut(v, 0, ranges) if role == "col" else v.clone()
        else:
            s_t = p["scale4"][idx]
            gk, gn, nb, _ = s_t.shape
            s = s_t.permute(0, 2, 1, 3).reshape(gk * nb, gn * quant.INT4_TILE_N)
            s = s[: -(-k // blk), :n]
            s = cut(s, 0, ranges, blk) if role == "row" else cut(s, 1, ranges)
            kk, nn = codes.shape
            part["scale4"] = quant.tile_scales(s, part[key].shape[2],
                                               nn + (-nn) % quant.INT4_TILE_N)
            part["n4"] = torch.zeros((nn, 0), dtype=torch.uint8, device=codes.device)
            part["k4"] = torch.zeros((kk, 0), dtype=torch.uint8, device=codes.device)
        for name, val in part.items():
            if name not in out:
                out[name] = val.new_empty(lead + tuple(val.shape)) if lead else val
            if lead:
                out[name][idx] = val
    if "bias" in p:
        out["bias"] = _narrow(p["bias"], -1, ranges) if role == "col" else p["bias"]
    return out


def _split_linear(p: dict, role: str, ranges, first: bool) -> dict:
    """One linear cut to ``ranges`` of its outputs ("col") or inputs ("row");
    ``first``: this rank keeps a rowwise bias (the others hold zeros)."""
    if p.keys() & {"q4r1", "q4b"}:
        out = _repack_tiled(p, role, ranges)
        if role == "row" and "bias" in p and not first:
            out["bias"] = _zeros_like(p["bias"])
        return out
    out = {}
    blk = quant.DEFAULT_BLOCK
    for name, x in p.items():
        if name == "code":
            out[name] = x
        elif role == "col":
            out[name] = _narrow(x, -1, ranges)
        elif name in ("kernel", "q8"):
            out[name] = _narrow(x, -2, ranges)
        elif name == "q4":
            out[name] = _narrow(x, -2, [(s // 2, m // 2) for s, m in ranges])
        elif name == "absmax":
            out[name] = _narrow(x, -2, [(s // blk, m // blk) for s, m in ranges])
        elif name == "bias":
            out[name] = x if first else _zeros_like(x)
        else:  # scale8: per output column
            out[name] = x
    return out


def _ranges(n: int, tp: int, m: int, halves: bool = False) -> list:
    if halves:
        h = n // 2
        return [(m * h // tp, h // tp), (h + m * h // tp, h // tp)]
    return [(m * n // tp, n // tp)]


@dataclass
class ShardPlan:
    """How a rank's local tree is laid out, and what the forward does about
    it: which sub-blocks are split over ``model`` (and so end in an all-reduce
    or, for the lm_head, an all-gather), the rank's experts, and the fsdp dim
    of each leaf (gathered before use)."""

    mesh: Mesh
    attn: bool = False
    mlp: bool = False
    lm_head: bool = False
    experts: Optional[tuple] = None  # (first, end) of this rank's experts
    fsdp_dims: Optional[dict] = None
    kept_whole: tuple = ()
    train: bool = False          # the differentiable mode (shard_params(train=True))
    model_dims: Optional[dict] = None  # the dim of each leaf split over model (None: whole)
    paths: tuple = ()            # the path of each local leaf, in tree_leaves order

    @property
    def tp(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    def _fsdp(self, path):
        return _lookup(self.fsdp_dims, path)

    def top(self, params: dict, keys=("wte", "lm_head", "ln_f")) -> dict:
        """``params`` with its top-level leaves ``keys`` gathered over fsdp;
        the blocks stay local (``layer`` gathers them)."""
        if self.fsdp_dims is None:
            return params
        g = self.mesh.group(FSDP_AXIS)
        gather = col.gather_scatter if self.train else col.all_gather
        out = dict(params)
        for key in keys:
            if key in params:
                out[key] = _walk(params[key], lambda path, x, key=key: x if self._fsdp(
                    (key,) + path) is None else gather(x, self._fsdp((key,) + path), g))
        return out

    def layers(self, blocks: dict, n_layer: int) -> list:
        """One function a layer that returns that layer's leaves (whole over
        fsdp, the rank's share over model). Training: the stacked local leaves
        are unbound here, once, and each function gathers its layer
        differentiably, so that called inside a remat body the gather runs
        again in the recompute. Serving: ``layer``'s gather."""
        if not self.train:
            return [lambda layer=layer: _slice_tree(*self.layer(blocks, layer))
                    for layer in range(n_layer)]
        g = self.mesh.group(FSDP_AXIS)
        fs = self.mesh.fsdp_ranks

        def views(path, x):
            return x if self._fsdp(("blocks",) + path) == 0 else x.unbind(0)

        per_leaf = _walk(blocks, views)

        def get(layer):
            def one(path, x):
                d = self._fsdp(("blocks",) + path)
                if d == 0:  # the layer axis itself is split: its owner sends it
                    per = x.shape[0]
                    owner = layer // per
                    return col.bcast_owner(x, layer - owner * per, fs[owner], g)
                return x[layer] if d is None else col.gather_scatter(x[layer], d - 1, g)
            return _walk(per_leaf, one)

        return [lambda layer=layer: get(layer) for layer in range(n_layer)]

    def splits(self, part: str) -> bool:
        """Whether sub-block ``part`` ("attn", "mlp", "experts", "lm_head")
        is split over ``model``."""
        return self.experts is not None if part == "experts" else getattr(self, part)

    def enter(self, x: torch.Tensor, part: str) -> torch.Tensor:
        """The input of sub-block ``part``: in training, where the sub-block is
        split over ``model``, its gradient is summed over ``model`` (each rank's
        share of the sub-block gives a part of it)."""
        if self.train and self.splits(part):
            return col.copy_f(x, self.mesh.group(MODEL_AXIS))
        return x

    def layer(self, blocks: dict, layer: int):
        """(block leaves, index) for layer ``layer``: the stacked local leaves
        and ``layer`` itself, or at fsdp > 1 this layer's leaves gathered, on a
        leading axis of one, and 0."""
        if self.fsdp_dims is None:
            return blocks, layer
        g = self.mesh.group(FSDP_AXIS)
        fs = self.mesh.fsdp_ranks

        def one(path, x):
            d = self._fsdp(("blocks",) + path)
            if d is None:
                return x[layer:layer + 1]
            if d > 0:
                return col.all_gather(x[layer:layer + 1], d, g)
            per = x.shape[0]  # the layer axis itself is split: the owner sends its layer
            owner = layer // per
            buf = x[layer - owner * per].clone() if self.mesh.coords[FSDP_AXIS] == owner \
                else torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
            return col.broadcast(buf, fs[owner], g)[None]

        return _walk(blocks, one), 0

    def reduce(self, y: torch.Tensor, part: str) -> torch.Tensor:
        """The sum over ``model`` of the partial outputs of a split sub-block:
        ``part`` "attn", "mlp" or "experts"."""
        if not self.splits(part):
            return y
        g = self.mesh.group(MODEL_AXIS)
        return col.reduce_g(y, g) if self.train else col.all_reduce(y, g)

    def logits(self, y: torch.Tensor) -> torch.Tensor:
        """The vocab-split logits gathered over ``model``."""
        if self.lm_head:
            g = self.mesh.group(MODEL_AXIS)
            return col.gather_slice(y, -1, g) if self.train else col.all_gather(y, -1, g)
        return y

    # ------------------------------------------------ training: batch, loss, gradients

    def batch_rows(self, batch):
        """This rank's rows of a global micro-batch (a tensor or a tuple of
        them), split over data x fsdp in the order of ``batch_spec``."""
        if isinstance(batch, tuple):
            return tuple(self.batch_rows(b) for b in batch)
        n = self.mesh.shape[DATA_AXIS] * self.mesh.shape[FSDP_AXIS]
        if batch.shape[0] % n:
            raise ValueError(f"micro-batch of {batch.shape[0]} rows must divide over "
                             f"dp*fsdp = {n} (the batch mesh axes)")
        i = self.mesh.coords[DATA_AXIS] * self.mesh.shape[FSDP_AXIS] + self.mesh.coords[FSDP_AXIS]
        step = batch.shape[0] // n
        return batch[i * step:(i + 1) * step]

    def global_mean(self, total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """The masked mean over the global batch from this rank's sum and
        count: its value is the whole batch's on every rank, its gradient the
        rank's own term's (the sum over the count of every rank's tokens), and
        the terms' gradients add up to the mean's (``sync_grads``)."""
        n = col.all_reduce(count.detach().clone(), self.mesh.batch_group)
        return col.reduce_g(total / torch.clamp(n, min=1.0), self.mesh.batch_group)

    def sync_grads(self, leaves: list, grads: list) -> list:
        """Each gradient summed over the ranks whose batches differ: over data
        for a leaf split over fsdp (its gather's reduce-scatter summed fsdp),
        over data x fsdp for the others. Over ``model`` nothing: the *f*/*g*
        pairs make each model rank's gradient whole for its share."""
        out = []
        for g, sp in zip(grads, self.leaf_splits(leaves)):
            if g is None:
                out.append(None)
                continue
            group = self.mesh.group(DATA_AXIS) if FSDP_AXIS in sp.dims.values() \
                else self.mesh.batch_group
            out.append(col.all_reduce(g, group))
        return out

    # ------------------------------------------------------------- each leaf's split

    def leaf_split(self, path: tuple, x) -> "LeafSplit":
        dims = {}
        md = _lookup(self.model_dims, path)
        if isinstance(md, int):
            dims[md] = MODEL_AXIS
        fd = self._fsdp(path)
        if isinstance(fd, int):
            dims[fd] = FSDP_AXIS
        whole = list(x.shape)
        for d, axis in dims.items():
            whole[d] *= self.mesh.shape[axis]
        halves = MODEL_AXIS in dims.values() and len(path) > 1 and path[-2] == "fc_12"
        return LeafSplit(self.mesh, tuple(whole), dims, halves)

    def leaf_splits(self, leaves: list) -> list:
        """The ``LeafSplit`` of each leaf of the plan's tree, in ``tree_leaves``
        order."""
        return [self.leaf_split(p, x) for p, x in zip(self.paths, leaves)]

    def gather_tree(self, tree: dict) -> dict:
        """A local tree made whole (every rank gets it): for saves."""
        return _walk(tree, lambda path, x: self.leaf_split(path, x).gather(x))

    def local_groups(self, cfg: Config) -> int:
        return cfg.n_query_groups // self.tp if self.attn else cfg.n_query_groups


def _lookup(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _slice_tree(tree: dict, layer: int) -> dict:
    return {k: _slice_tree(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in tree.items()}


def tree_paths(tree: dict, prefix: tuple = ()) -> list:
    """The path of every leaf, in ``tree_leaves`` order."""
    out = []
    for k, v in tree.items():
        out.extend(tree_paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)])
    return out


@dataclass
class LeafSplit:
    """How one training leaf is split on the mesh: ``whole`` is the whole
    leaf's shape, ``dims`` maps each split dim to its axis ("model",
    "fsdp"); ``halves``: a fused fc_12, whose model split takes a block of
    each half. The optimizers read it: the axes a leaf's sums run over
    (the gradient norm, Adafactor's statistics), its whole shape and flat
    order (Adafactor's factoring, AdamW8bit's blocks)."""

    mesh: Mesh
    whole: tuple
    dims: dict = field(default_factory=dict)
    halves: bool = False

    @property
    def axes(self) -> frozenset:
        return frozenset(self.dims.values())

    def sum_over(self, t: torch.Tensor, reduced: tuple) -> torch.Tensor:
        """``t``, a sum over the whole-leaf dims ``reduced`` of this rank's
        shard, summed over the ranks that split those dims."""
        for d, axis in self.dims.items():
            if d in reduced:
                t = col.all_reduce(t, self.mesh.group(axis))
        return t

    def sum_all(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum_over(t, tuple(self.dims))

    def gather(self, x: torch.Tensor, dims: Optional[dict] = None) -> torch.Tensor:
        """The whole leaf from every rank's shard (every rank gets it). ``dims``
        (default: the leaf's): the split dims of a tensor laid out otherwise
        (Adafactor's row and column statistics)."""
        dims = self.dims if dims is None else dims
        for axis in (FSDP_AXIS, MODEL_AXIS):  # the reverse of the cut's order
            for d, a in dims.items():
                if a == axis:
                    n = self.mesh.shape[axis]
                    x = col.all_gather(x, d, self.mesh.group(axis))
                    if axis == MODEL_AXIS and self.halves:
                        blocks = x.chunk(2 * n, d)  # rank r's two blocks: 2r, 2r + 1
                        x = torch.cat(blocks[0::2] + blocks[1::2], d)
        return x

    def cut(self, x: torch.Tensor, dims: Optional[dict] = None) -> torch.Tensor:
        """This rank's shard of the whole leaf ``x`` (the inverse of ``gather``)."""
        dims = self.dims if dims is None else dims
        for axis in (MODEL_AXIS, FSDP_AXIS):
            for d, a in dims.items():
                if a == axis:
                    n, i = self.mesh.shape[axis], self.mesh.coords[axis]
                    ranges = _ranges(x.shape[d], n, i, self.halves and axis == MODEL_AXIS)
                    x = _narrow(x, d, ranges)
        return x.contiguous()


class ShardedParams(dict):
    """A rank's local parameter tree, carrying its ``ShardPlan`` (``.plan``)."""

    plan: ShardPlan


def split_plan(cfg: Config, params: dict, tp: int, train: bool = False) -> dict:
    """Which sub-blocks can be split ``tp`` ways over ``model``: {"attn",
    "mlp", "lm_head", "experts": bool, "kept_whole": [names]} from the tree's
    shapes and formats (leaves may be lazy). A linear arm's attention is split
    by its heads in training (``train``), where no running state is kept."""
    blocks = params["blocks"]
    kept = []
    if tp <= 1:
        return {"attn": False, "mlp": False, "lm_head": False, "experts": False,
                "kept_whole": kept}
    attn = blocks["attn"]
    from ..models.gpt import LINEAR_ALGS

    attn_ok = (cfg.n_query_groups % tp == 0 and (train or cfg.attn_alg not in LINEAR_ALGS)
               and "adapter" not in attn and _can_split(attn["attn"], "col", tp)
               and _can_split(attn["proj"], "row", tp))
    if not attn_ok:
        kept += ["attn.attn", "attn.proj"]
    mlp = blocks["mlp"]
    experts = "experts" in mlp
    if experts:
        mlp_ok = cfg.n_expert % tp == 0 and all(
            not (set(p) - {"kernel", "bias"}) for p in mlp["experts"].values())
        if not mlp_ok:
            kept.append("mlp.experts")
    else:
        mlp_ok = all(_can_split(p, "row" if name == "proj" else "col", tp, name == "fc_12")
                     for name, p in mlp.items() if _is_linear(p))
        if not mlp_ok:
            kept += [f"mlp.{n}" for n, p in mlp.items() if _is_linear(p)]
    head_ok = _can_split(params["lm_head"], "col", tp)
    if not head_ok:
        kept.append("lm_head")
    return {"attn": attn_ok, "mlp": mlp_ok and not experts, "experts": mlp_ok and experts,
            "lm_head": head_ok, "kept_whole": kept}


def _role(lin_path: tuple, split: dict) -> Optional[str]:
    """"col" or "row": how ``split`` cuts the linear at ``lin_path`` over
    ``model`` (None: it stays whole)."""
    if lin_path[0] == "lm_head":
        return "col" if split["lm_head"] else None
    if lin_path[:2] == ("blocks", "attn") and split["attn"] and lin_path[-1] in ("attn", "proj"):
        return "col" if lin_path[-1] == "attn" else "row"
    if lin_path[:2] == ("blocks", "mlp") and split["mlp"] and lin_path[-1] != "gate":
        return "row" if lin_path[-1] == "proj" else "col"
    return None


def split_tree(cfg: Config, params: dict, mesh, split: dict, train: bool = False) -> dict:
    """The rank's model-axis cut of ``params`` by ``split`` (see
    ``split_plan``); leaves are tensors or lazy leaves with ``narrow``.
    ``train``: a rowwise bias stays whole on every rank (the forward adds it
    after the sum) instead of on the first."""
    tp, m = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    first = m == 0 or train

    def walk(node, path):
        if _is_linear(node) and "experts" not in path:
            role = _role(path, split)
            if role is None:
                return node
            k, n = linear_features(node)
            halves = path[-1] == "fc_12"
            return _split_linear(node, role, _ranges(n if role == "col" else k, tp, m, halves),
                                 first)
        if isinstance(node, dict):
            if path[-1:] == ("experts",) and split["experts"]:
                e = cfg.n_expert
                return _walk(node, lambda _p, x: x.narrow(1, m * e // tp, e // tp))
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return {k: walk(v, (k,)) for k, v in params.items()}


def fsdp_dims(tree: dict, fsdp_size: int, model_dims: Optional[dict] = None) -> Optional[dict]:
    """The dim of each local leaf split over fsdp: the largest dim that
    fsdp_size divides and that is not split over model (the reference's
    ``_fsdp_dim``); None when fsdp_size is 1."""
    if fsdp_size <= 1:
        return None

    def pick(path, x):
        skip = ()
        if model_dims is not None:
            d = model_dims
            for k in path:
                d = d.get(k) if isinstance(d, dict) else None
            skip = (d,) if isinstance(d, int) else ()
        spec = _fsdp_dim((None,) * len(x.shape), tuple(x.shape), True, fsdp_size, skip)
        return spec.index(FSDP_AXIS) if FSDP_AXIS in spec else None

    return _walk(tree, pick)


def _model_dims(cfg: Config, params: dict, split: dict) -> dict:
    """The dim of each whole leaf that the model split cuts (None if none),
    for the fsdp rule's exclusion."""
    def dim(path, x):
        if "experts" in path:
            return 1 if split["experts"] else None
        role = _role(path[:-1], split) if len(path) > 1 else None
        name = path[-1]
        if role is None or name == "code" or (role == "row" and name in ("bias", "scale8", "v4")) \
                or (role == "col" and name == "u4"):
            return None
        return len(x.shape) - (1 if role == "col" else 2)

    return _walk(params, dim)


def layout_specs(cfg: Config, params: dict, *, tp: int = 1, fsdp_size: int = 1) -> dict:
    """The port's cut of each leaf (``shard_params`` at this tp and fsdp) in
    the reference's spec form: per dim "model", "fsdp" or None. It equals the
    reference's sanitized ``param_specs`` except where the port keeps a
    sub-block whole (``split_plan``), and for a colwise int8 linear's
    ``scale8``, which the port cuts with its columns. (The tiled int4 leaves
    are re-packed for a shard and have no such form.)"""
    split = split_plan(cfg, params, tp)
    mdims = _model_dims(cfg, params, split)

    def spec(path, x):
        d = mdims
        for k in path:
            d = d[k]
        s = [None] * len(x.shape)
        if d is not None:
            s[d] = MODEL_AXIS
        return _fsdp_dim(tuple(s), tuple(x.shape), fsdp_size > 1, fsdp_size)

    return _walk(params, spec)


def _fsdp_cut(tree: dict, dims: Optional[dict], mesh) -> dict:
    if dims is None:
        return tree
    f, n = mesh.coords[FSDP_AXIS], mesh.shape[FSDP_AXIS]

    def cut(path, x):
        d = dims
        for k in path:
            d = d[k]
        if d is None:
            return x
        step = x.shape[d] // n
        return x.narrow(d, f * step, step)

    return _walk(tree, cut)


def shard_params(params: dict, mesh, cfg: Config, *, tp: Optional[bool] = None,
                 materialize=None, train: bool = False) -> ShardedParams:
    """This rank's local tree of a whole ``params`` (tensors, or lazy leaves
    from ``utils/sharded_load.py`` with ``materialize`` turning each local
    leaf into a tensor), with its ``ShardPlan`` as ``.plan``. ``tp=False``
    keeps every leaf whole over ``model`` (the reference's pure fsdp
    layout). ``train``: the plan's differentiable mode (see the module doc);
    the tiled int4 formats, serving's, are refused there."""
    n_tp = mesh.shape[MODEL_AXIS] if (tp is None or tp) else 1
    if train:
        tiled = [p for p in tree_paths(params) if p[-1] in ("q4r1", "q4b")]
        if tiled:
            raise ValueError(f"the tiled int4 formats are serving's, not training's: {tiled[0]}")
    split = split_plan(cfg, params, n_tp, train)
    local = split_tree(cfg, params, mesh, split, train)
    fsdp = mesh.shape[FSDP_AXIS]
    mdims = _model_dims(cfg, params, split)
    dims = fsdp_dims(local, fsdp, mdims)
    local = _fsdp_cut(local, dims, mesh)
    if materialize is not None:
        local = _walk(local, lambda _p, x: materialize(x))
    else:
        local = _walk(local, lambda _p, x: x.contiguous())
    e = cfg.n_expert if split["experts"] else 0
    m = mesh.coords[MODEL_AXIS]
    plan = ShardPlan(mesh, attn=split["attn"], mlp=split["mlp"], lm_head=split["lm_head"],
                     experts=(m * e // n_tp, (m + 1) * e // n_tp) if e else None,
                     fsdp_dims=dims, kept_whole=tuple(split["kept_whole"]) if n_tp > 1 else (),
                     train=train, model_dims=mdims, paths=tuple(tree_paths(local)))
    out = ShardedParams(local)
    out.plan = plan
    return out


def tree_bytes(tree) -> int:
    total = 0

    def add(_p, x):
        nonlocal total
        total += x.numel() * x.element_size()
        return x

    _walk(tree, add)
    return total
