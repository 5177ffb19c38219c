"""Serving benchmark: aggregate throughput and latency over the continuous
batcher (counterpart of ``fastmax_tpu/inference/bench_serving.py``).

``run_load`` drives a batcher through a closed-loop load (every request
queued up front: the peak-throughput number) or an open-loop Poisson
arrival process (latency under load), timing on the host clock around
``step()``, the loop a server runs, so the host's own overheads count.
``run`` builds the model (a checkpoint directory through
``generate.load_and_prepare``, or ``model_name``'s config with random
weights drawn on the device from ``seed``, then quantized), runs one warm-up
request, then one load of random prompts, and prints one JSON line:

    python -m fastmax_tpu_torch.inference.bench_serving --model_name Llama-2-7b-hf \
        --quantize bnb.nf4 --kv_cache_dtype int8 --n_slots 8 --decode_quantum 8 \
        --n_requests 16 --prompt_len 64 --max_new_tokens 64 [--device cpu]

With ``--speculative_k`` the line carries ``spec_acceptance``, the drafts
accepted over the drafts offered, beside the rates.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


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
    out = {
        "n_requests": n,
        "generated_tokens": int(gen_tokens),
        "aggregate_tok_s": round(gen_tokens / t_total, 2),
        "wall_s": round(t_total, 2),
        "ttft_p50_ms": round(float(np.percentile(ttft, 50)) * 1e3, 1),
        "ttft_p95_ms": round(float(np.percentile(ttft, 95)) * 1e3, 1),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 3),
        "latency_p95_s": round(float(np.percentile(lat, 95)), 3),
    }
    drafted = getattr(batcher, "spec_drafted", 0)
    if drafted:
        # how often the drafts land, beside a speculative run's rates
        out["spec_acceptance"] = round(batcher.spec_accepted / drafted, 3)
    return out


def run(
    checkpoint_dir: Optional[Path] = None,
    model_name: Optional[str] = None,
    quantize: Optional[str] = None,
    attn_alg: Optional[str] = None,
    precision: str = "bfloat16",
    weights_mode: str = "auto",
    n_slots: int = 8,
    decode_quantum: int = 1,
    speculative_k: int = 0,
    prefill_chunk: int = 0,
    kv_cache_dtype: Optional[str] = None,
    max_seq_length: Optional[int] = None,
    n_requests: int = 32,
    prompt_len: int = 64,
    max_new_tokens: int = 128,
    arrival_rate: float = 0.0,
    seed: int = 0,
    device=None,
) -> dict:
    """Build the model (random weights with ``model_name``, a checkpoint with
    ``checkpoint_dir``) on the card (``device="cpu"`` for the CPU), run one
    load, print one JSON line and return it."""
    from ..models import gpt
    from ..models.config import Config
    from .continuous import ContinuousBatcher
    from .engine import default_device
    from .generate import load_and_prepare

    device = default_device(device)
    if checkpoint_dir is not None:
        cfg, params = load_and_prepare(Path(checkpoint_dir), quantize=quantize,
                                       attn_alg=attn_alg, precision=precision, device=device)
    else:
        kw = {"attn_alg": attn_alg} if attn_alg else {}
        cfg = Config.from_name(model_name or "pythia-14m", **kw)
        params = gpt.init_params(cfg, seed, getattr(torch, precision), device)
        if quantize:
            from ..ops.quant import quantize_model

            params = quantize_model(params, quantize)

    seq_need = prompt_len + max_new_tokens + max(speculative_k + 1, decode_quantum)
    cfg.block_size = max(cfg.block_size, seq_need)
    batcher = ContinuousBatcher(
        cfg, params, n_slots=n_slots, max_seq_length=max_seq_length or seq_need,
        weights_mode=weights_mode, decode_quantum=decode_quantum, speculative_k=speculative_k,
        prefill_chunk=prefill_chunk,
        cache_dtype=getattr(torch, kv_cache_dtype) if kv_cache_dtype else None, device=device)
    del params

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.padded_vocab_size, size=(prompt_len,)).astype(np.int32)
               for _ in range(n_requests)]

    # warm-up: the kernels' builds and the first calls, outside the measured load
    w = batcher.submit(prompts[0], 4, temperature=0.0, return_request=True)
    while not w.done:
        batcher.step()

    result = run_load(batcher, prompts, max_new_tokens, arrival_rate=arrival_rate, seed=seed)
    result = {"metric": "serving_aggregate_decode", "model": cfg.name, "n_slots": n_slots,
              "decode_quantum": decode_quantum, **result}
    print(json.dumps(result))
    return result


def main(args=None) -> dict:
    """The command line: ``run``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    return CLI(run, args)


if __name__ == "__main__":
    main()
