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


def require_ranks(n: int, module: str) -> None:
    """Raise unless a process group of a multiple of ``n`` ranks is up: a
    sharded entry point never quietly serves on one rank."""
    if n > 1 and not init_from_env(timeout=SERVING_TIMEOUT):
        raise RuntimeError(
            f"tp * fsdp = {n} needs {n} ranks: start it as `{torchrun_line(module, n)} ...` "
            "(one process per rank)")
    if n > 1 and dist.get_world_size() % n:
        raise RuntimeError(f"tp * fsdp = {n} does not divide the world size "
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
