"""Every collective of the port's multi-GPU serving, in one place.

The JAX package never writes a collective: its single controller annotates
arrays with ``NamedSharding`` and XLA's SPMD partitioner inserts the
all-gathers and psums (``fastmax_tpu/parallel/sharding.py``). The port runs
one process per rank on ``torch.distributed``, so each collective that GSPMD
inserted is written out here and called by name:

* ``all_reduce``: the sum of the partial outputs of a rowwise linear
  (``attn.proj``, ``mlp.proj``) and of the local experts of an MoE layer,
  over the ``model`` axis;
* ``all_gather``: the vocab-split logits over ``model``; at ``fsdp > 1`` each
  layer's leaves just before the layer runs, over ``fsdp``; the generated
  rows of a batch split over ``data x fsdp``;
* ``broadcast`` / ``broadcast_ints``: the serving plan (admitted requests)
  and the sampled tokens, from the rank that decides them, so that the ranks
  never take different host decisions.

These are outside autograd: the serving path never runs a backward. Training
(``models/gpt.py`` under a ``ShardPlan`` in its differentiable mode, the
sequence-parallel loss) calls their differentiable pairs, each an
``autograd.Function`` whose backward is the transpose of its forward, as
XLA's transposes of the reference's collectives are:

* ``reduce_g``: all-reduce forward, identity backward (Megatron's *g*), after
  a rowwise linear;
* ``copy_f``: identity forward, all-reduce backward (Megatron's *f*), at the
  entry of a colwise sub-block, so that the replicated residual stream's
  gradient is the whole sum on every model rank;
* ``gather_slice``: all-gather forward, this rank's slice backward (the
  vocab-split logits, whose loss every model rank computes alike);
* ``gather_scatter``: all-gather forward, reduce-scatter backward (a leaf
  gathered over fsdp: its gradient is summed over the fsdp ranks' batches);
* ``bcast_owner``: the owner's broadcast forward, a sum to the owner
  backward (a layer of a leaf whose layer axis is split over fsdp);
* ``ring_shift``: rank i's tensor to rank i + 1 forward, the reverse
  backward (ring attention's K/V rotation, the pipeline's stage-to-stage
  send);
* ``scale_grad``: identity forward, the gradient times a constant backward
  (a loss that several ranks compute alike, each counting its share).

``shift`` sends and receives point to point under NCCL; under gloo, whose
point-to-point send of a CUDA tensor aborts the process (its TCP pair writes
from the device pointer: ``writev ... Bad address`` on the H100 host), it is
built from what gloo does take on CUDA tensors: an all-gather, of which each
rank keeps its neighbour's part. The function is the same.

Launch: ``init_from_env`` reads torchrun's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``; ``spawn_local`` starts N ranks of a function on 127.0.0.1
(the CPU tests with gloo, and two ranks sharing one card in ``chip_smoke.py``).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# The serving followers wait in a broadcast while the leader is idle: give such
# groups a day before gloo or NCCL calls the wait a hang.
SERVING_TIMEOUT = datetime.timedelta(days=1)
# A training group never waits on a user: a rank that died takes the others down
# within this, not a day later.
TRAINING_TIMEOUT = datetime.timedelta(minutes=30)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place (a copy if ``x`` is not
    contiguous); ``x`` itself for a group of one."""
    if _size(group) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in the group's rank order."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place."""
    if _size(group) == 1:
        return x
    if not x.is_contiguous():
        raise ValueError("broadcast needs a contiguous tensor")
    dist.broadcast(x, src=src, group=group)
    return x


def _rank_in(group) -> int:
    return 0 if group is None else dist.get_group_rank(group, dist.get_rank())


# the single-tensor reduce-scatter (renamed in later releases of torch)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, cut along ``dim`` into equal blocks
    in rank order: this rank's block."""
    n = _size(group)
    if n == 1:
        return x
    whole = x.movedim(dim, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // n,) + tuple(whole.shape[1:]))
    _REDUCE_SCATTER(out, whole, group=group)
    return out.movedim(0, dim)


def shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """The ring shift: rank i of ``group`` receives rank (i - step) mod n's
    ``x`` (so it sends its own to i + step)."""
    n = _size(group)
    if n == 1 or step % n == 0:
        return x
    i = _rank_in(group)
    if dist.get_backend(group) == "nccl":
        x = x.contiguous()
        out = torch.empty_like(x)
        peer = dist.get_global_rank
        ops = [dist.P2POp(dist.isend, x, peer(group, (i + step) % n), group),
               dist.P2POp(dist.irecv, out, peer(group, (i - step) % n), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts[(i - step) % n]


# ------------------------------------------------- the differentiable collectives


class _ReduceG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = _size(ctx.group)
        return g.chunk(n, ctx.dim)[_rank_in(ctx.group)].contiguous(), None, None


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _BcastOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stacked, index, owner, group):
        ctx.index, ctx.owner, ctx.group = index, owner, group
        ctx.shape = stacked.shape
        mine = dist.get_rank() == owner
        buf = stacked[index].clone() if mine else \
            torch.empty(stacked.shape[1:], dtype=stacked.dtype, device=stacked.device)
        return broadcast(buf, owner, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.clone(), ctx.group)
        out = g.new_zeros(ctx.shape)
        if dist.get_rank() == ctx.owner:
            out[ctx.index] = g
        return out, None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


def reduce_g(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (forward); the gradient passes through as it is."""
    return x if _size(group) == 1 else _ReduceG.apply(x, group)


def copy_f(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself (forward); its gradient is summed over ``group``."""
    return x if _size(group) == 1 else _CopyF.apply(x, group)


def gather_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` (forward); this rank's slice of the gradient."""
    return x if _size(group) == 1 else _GatherSlice.apply(x, dim, group)


def gather_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` (forward); the gradient reduce-scattered."""
    return x if _size(group) == 1 else _GatherScatter.apply(x, dim, group)


def bcast_owner(stacked: torch.Tensor, index: int, owner: int, group) -> torch.Tensor:
    """``stacked[index]`` of global rank ``owner`` on every rank of ``group``
    (forward); the gradient summed over ``group`` into the owner's entry."""
    if _size(group) == 1:
        return stacked[index]
    return _BcastOwner.apply(stacked, index, owner, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``shift(x, group, 1)`` (forward); the gradient shifted back."""
    return x if _size(group) == 1 else _RingShift.apply(x, group)


def scale_grad(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x`` itself (forward); its gradient times ``c``."""
    return x if c == 1 else _ScaleGrad.apply(x, c)


def all_true(flag: bool, group, device) -> bool:
    """Whether ``flag`` holds on every rank of ``group``."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    if _size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def broadcast_ints(values: Optional[np.ndarray], src: int, group, device) -> np.ndarray:
    """A 1-D int64 array of any length from global rank ``src`` (which passes
    it; the others pass None) to every rank of ``group``: its length in a
    fixed one-element message, then its values."""
    n = torch.zeros(1, dtype=torch.int64, device=device)
    if dist.get_rank() == src:
        values = np.ascontiguousarray(values, np.int64).reshape(-1)
        n.fill_(values.size)
    broadcast(n, src, group)
    buf = (torch.from_numpy(values).to(device) if dist.get_rank() == src
           else torch.empty(int(n.item()), dtype=torch.int64, device=device))
    broadcast(buf, src, group)
    return buf.cpu().numpy()


def agree(choice: str, options: Sequence[str], device) -> str:
    """Global rank 0's ``choice`` (one of ``options``) on every rank: a host
    decision (a timed probe, an autotune) made once, so that no two ranks run
    different kernels."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return choice
    mine = np.array([list(options).index(choice)]) if dist.get_rank() == 0 else None
    return options[int(broadcast_ints(mine, 0, dist.group.WORLD, device)[0])]


def init_from_env(backend: Optional[str] = None, timeout=None) -> bool:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); a no-op when a group is
    already up (``spawn_local``'s ranks). Returns whether one is up. The
    backend defaults to NCCL where CUDA is available, which needs a card for
    each local rank (it raises otherwise), and to gloo without CUDA; pass
    ``backend`` to choose another."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "gloo"
        if torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
            if torch.cuda.device_count() < local:
                raise RuntimeError(f"{local} ranks on this host but {torch.cuda.device_count()} "
                                   "cards: NCCL takes one card a rank")
            backend = "nccl"
    kw = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group(backend, **kw)
    return True


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:LOCAL_RANK``
    (raises where this host has no such card)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
    if local_rank() >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank()} has no card: this host has "
                           f"{torch.cuda.device_count()}")
    return torch.device("cuda", local_rank())


def torchrun_line(module: str, n: int) -> str:
    return f"torchrun --nproc_per_node {n} -m {module}"


def require_ranks(n: int, module: str, timeout=SERVING_TIMEOUT, what: str = "tp * fsdp") -> None:
    """Raise unless a process group of a multiple of ``n`` ranks is up: a
    sharded entry point never quietly serves or trains on one rank."""
    if n > 1 and not init_from_env(timeout=timeout):
        raise RuntimeError(
            f"{what} = {n} needs {n} ranks: start it as `{torchrun_line(module, n)} ...` "
            "(one process per rank)")
    if n > 1 and dist.get_world_size() % n:
        raise RuntimeError(f"{what} = {n} does not divide the world size "
                           f"{dist.get_world_size()}")


# ------------------------------------------------------------------ spawn_local


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, tasks, results,
               threads: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    # the ranks are on this host: gloo talks over the loopback device, without looking up
    # the host's name (which can stall for seconds where no resolver answers)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        if threads:
            # a fresh process's first exp after a matmul on several threads now and then
            # differs from later calls: warm both on one thread, then cap the threads
            torch.set_num_threads(1)
            torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
            torch.set_num_threads(threads)
        fn, args = tasks.get()
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(minutes=10))
        out = fn(*args)
        results.put((rank, "ok", out))
    except BaseException:  # report every failure to the parent, then exit non-zero
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn: Callable, world_size: int, backend: str = "gloo", args: Sequence = (),
                timeout: float = 600.0, threads: int = 1) -> list:
    """Run ``fn(*args)`` on ``world_size`` fresh processes joined in one
    process group on 127.0.0.1 (``backend``; each sets ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` as torchrun does) and return their
    results in rank order. ``fn`` must be importable by name (a module-level
    function) and its results picklable. Raises if any rank fails or the
    group does not finish within ``timeout`` seconds; every process started
    is ended before it returns. ``threads``: the torch CPU threads of each
    rank (0 leaves the default)."""
    ctx = mp.get_context("spawn")
    results, tasks = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, port, backend, tasks, results,
                                                   threads), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    # the work goes through a queue, not the start arguments, so that a large one does
    # not hold each start until its process has come up
    for _ in procs:
        tasks.put((fn, tuple(args)))
    got, errors = {}, []
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(got) + len(errors) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                raise TimeoutError(f"spawn_local: {world_size} ranks of {fn.__name__} did not "
                                   f"finish in {timeout} s (done: {sorted(got)})")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except Exception:  # queue.Empty: look for ranks that died without a word
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"spawn_local: a rank of {fn.__name__} exited with "
                                       f"{dead} before reporting")
                continue
            if status == "ok":
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if errors:
            raise RuntimeError(f"spawn_local: {fn.__name__} failed\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=max((deadline - datetime.datetime.now()).total_seconds(), 1.0))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        for q in (results, tasks):
            q.close()
            q.cancel_join_thread()
