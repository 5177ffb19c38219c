"""CUDA-graph timing shared by the labs' timers.

The reference labs chain many calls inside one jitted loop so that the TPU's
dispatch cost cancels. Here the chained calls are captured in one CUDA graph
and the graph is replayed under CUDA events: device time, no host time inside.
Each timer counts the calls it makes to the timed function (warm-up and
capture; a replay makes none), so that a lab line can show that every call
launched the kernel.
"""

from __future__ import annotations

import torch

from ..kernels import build


def require_cuda() -> None:
    build._require_cuda()


def total_launches() -> int:
    return sum(build.launch_counts().values())


class Counted:
    """fn with a count of its calls."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def capture(body) -> torch.cuda.CUDAGraph:
    """``body()`` run once on a side stream (builds and warms the kernels),
    then captured into a graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph


def replay_s(graph: torch.cuda.CUDAGraph, reps: int, times: int = 1) -> float:
    """Best over ``reps`` of the seconds ``times`` replays of ``graph`` take."""
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(times):
            graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best
