"""Serving load over the continuous batcher: aggregate throughput and
latency percentiles (counterpart of ``run_load`` in
``fastmax_tpu/inference/bench_serving.py``).

``run_load`` drives a batcher through a closed-loop load (every request
queued up front: the peak-throughput number) or an open-loop Poisson
arrival process (latency under load), timing on the host clock around
``step()``, the loop a server runs, so the host's own overheads count.
The reference's command line (``run``/``main``) builds its model from a
checkpoint or from the JAX package's initializer; it waits for the
tokenizer and the inference command lines (ROADMAP.md queue A, A7 slice 2).
"""

from __future__ import annotations

import time

import numpy as np


def run_load(batcher, prompts, max_new_tokens: int, *, arrival_rate: float = 0.0,
             seed: int = 0) -> dict:
    """Drive ``batcher`` through one greedy load of ``prompts``.

    arrival_rate: 0 = closed loop (everything queued up front); > 0 =
    Poisson arrivals at that many requests per second. Returns aggregate
    tok/s, TTFT and latency percentiles."""
    rng = np.random.default_rng(seed)
    n = len(prompts)
    gaps = rng.exponential(1.0 / arrival_rate, n) if arrival_rate > 0 else np.zeros(n)
    arrive_at = np.cumsum(gaps)

    reqs = []
    submit_t = {}
    first_t = {}
    done_t = {}
    t0 = time.perf_counter()
    next_i = 0
    while len(done_t) < n:
        now = time.perf_counter() - t0
        while next_i < n and arrive_at[next_i] <= now:
            r = batcher.submit(prompts[next_i], max_new_tokens, temperature=0.0,
                               return_request=True)
            submit_t[r.request_id] = time.perf_counter()
            reqs.append(r)
            next_i += 1
        if next_i < n and not batcher.inflight():
            # open loop: idle until the next arrival
            time.sleep(min(arrive_at[next_i] - now, 0.01))
            continue
        batcher.step()
        t = time.perf_counter()
        for r in reqs:
            if r.request_id not in first_t and r.generated:
                first_t[r.request_id] = t
            if r.request_id not in done_t and r.done:
                done_t[r.request_id] = t
    t_total = time.perf_counter() - t0

    gen_tokens = sum(len(r.generated) for r in reqs)
    lat = np.asarray([done_t[r.request_id] - submit_t[r.request_id] for r in reqs])
    ttft = np.asarray([first_t[r.request_id] - submit_t[r.request_id] for r in reqs])
    return {
        "n_requests": n,
        "generated_tokens": int(gen_tokens),
        "aggregate_tok_s": round(gen_tokens / t_total, 2),
        "wall_s": round(t_total, 2),
        "ttft_p50_ms": round(float(np.percentile(ttft, 50)) * 1e3, 1),
        "ttft_p95_ms": round(float(np.percentile(ttft, 95)) * 1e3, 1),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 3),
        "latency_p95_s": round(float(np.percentile(lat, 95)), 3),
    }
