"""The port's ContinuousBatcher (fastmax_tpu_torch/inference/continuous.py)
against fastmax_tpu.inference.continuous.ContinuousBatcher on the CPU: the
same rank-1 int4 weights, the same requests submitted in the same order
with the same steps in between; the greedy tokens of every request must be
identical, in every mode: single and interleaved requests, eos, batched
admission with mixed buckets, int8 cache, decode quantum, adaptive quantum,
chunked prefill, prefix cache, and a model at max_seq_length 2048 whose
prefills take the flash route (through its plain version here; the JAX
package takes its flash kernel on the TPU only). Also: per-slot cache
writes against scalar ones, top-k sampling, and sampling reproducible from
a seeded generator. float32 activations."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference.continuous import ContinuousBatcher as JaxBatcher
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.ops import flash_attention as fa

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(block_size=128, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False, parallel_residual=False)  # as Llama-2
# head size 64, so that a 2048-token cache is flash-eligible
LONG = {**TINY, "block_size": 2048, "head_size": 64}


@functools.lru_cache(maxsize=None)
def _params(long: bool = False):
    cfg = LONG if long else TINY
    dense = jgpt.init_params(JaxConfig(**cfg), jax.random.PRNGKey(0), jnp.float32)
    tree = JaxEngine.prepare_params(jquant.quantize_model(dense, "bnb.nf4"), "preload_int4")
    return tree, from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


def _make(kind, long=False, int8=False, **kw):
    jp, tp = _params(long)
    cfg = LONG if long else TINY
    kw.setdefault("max_seq_length", cfg["block_size"])
    if kind == "jax":
        return JaxBatcher(JaxConfig(**cfg), jp, weights_mode="quantized",
                          cache_dtype=jnp.int8 if int8 else None, **kw)
    return ContinuousBatcher(Config(**cfg), tp, weights_mode="quantized",
                             cache_dtype=torch.int8 if int8 else None, device="cpu", **kw)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, (n,)).astype(np.int32) for n in lengths]


# Scenarios: each drives one batcher, of either package, and returns what the
# two must agree on.

def single(b):
    rid = b.submit(np.arange(1, 11, dtype=np.int32), 12, temperature=0.0)
    return b.run_to_completion()[rid]


def interleaved(b):
    """Three requests on two slots; the third joins mid-flight."""
    p1, p2, p3 = _prompts(0, (10, 17, 3))
    r1, r2 = b.submit(p1, 10), b.submit(p2, 10)
    for _ in range(3):
        b.step()
    r3 = b.submit(p3, 10)
    res = b.run_to_completion()
    return [res[r1], res[r2], res[r3]]


def eos(b):
    """eos 5th in the greedy run: the request stops there and frees its slot."""
    prompt = np.arange(1, 11, dtype=np.int32)
    eos_id = int(_ref_eos)
    rid = b.submit(prompt, 20, eos_id=eos_id)
    first = b.run_to_completion()[rid]
    rid2 = b.submit(prompt, 3)
    return [first, b.run_to_completion()[rid2]]


def mixed_buckets(b):
    """A 4-slot wave with bucket lengths 64 and 128 mixed in the queue: FIFO
    waves through the batched admission prefill, the rest one by one."""
    reqs = [b.submit(p, 8, return_request=True)
            for p in _prompts(4, (8, 70, 5, 9, 7, 6, 11, 4, 12))]
    while not all(r.done for r in reqs):
        b.step()
    return [r.generated for r in reqs] + [b.batched_admissions]


def wave(b):
    """Four requests of one bucket: one batched admission wave."""
    reqs = [b.submit(p, 12, return_request=True) for p in _prompts(3, (8, 11, 5, 9))]
    while not all(r.done for r in reqs):
        b.step()
    assert b.batched_admissions == 4, "the wave did not take the batched path"
    return [r.generated for r in reqs]


def quantum_eos(b):
    """Decode quantum: a request joining after the first quantum, and eos
    landing in the middle of a quantum."""
    p1, p2 = _prompts(5, (10, 11))
    r1 = b.submit(p1, 13)
    b.step()
    r2 = b.submit(p2, 13)
    res = b.run_to_completion()
    r3 = b.submit(p1, 20, eos_id=int(_ref_eos))
    return [res[r1], res[r2], b.run_to_completion()[r3]]


def chunked(b):
    """Prompts longer than, shorter than and a multiple of the chunk, with a
    request decoding while a long one prefills."""
    short = np.asarray([3, 4, 5], np.int32)
    r0 = b.submit(short, 20)
    b.step()
    rids = [b.submit(p, 8) for p in (np.arange(1, 40, dtype=np.int32),
                                     np.arange(50, 82, dtype=np.int32))]
    res = b.run_to_completion()
    return [res[r0]] + [res[r] for r in rids]


def prefix(b):
    """A registered 40-token system prompt shared by three requests, and two
    requests without it; the hit count shows the reuse."""
    system = np.arange(1, 41, dtype=np.int32)
    b.register_prefix(system)
    prompts = [np.concatenate([system, np.asarray(s, np.int32)])
               for s in ([50, 51, 52], [60, 61], [70, 71, 72, 73])] + _prompts(6, (9, 5))
    rids = [b.submit(p, 10) for p in prompts]
    res = b.run_to_completion()
    return [res[r] for r in rids] + [b.prefix_cache_hits]


def long_prompts(b):
    """Prompts of 300-700 tokens on a 2048-token cache: single, batched
    (with 512-token buckets) and chunked prefills all take the flash route."""
    reqs = [b.submit(p, 10, return_request=True) for p in _prompts(7, (300, 450, 500, 700))]
    while not all(r.done for r in reqs):
        b.step()
    return [r.generated for r in reqs]


_ref_eos = None


def _set_ref_eos():
    """eos = the 5th greedy token of the single-request prompt (JAX batcher)."""
    global _ref_eos
    if _ref_eos is None:
        b = _make("jax", n_slots=1)
        rid = b.submit(np.arange(1, 11, dtype=np.int32), 20)
        _ref_eos = b.run_to_completion()[rid][4]


CASES = {
    "single": (single, dict(n_slots=2)),
    "interleaved": (interleaved, dict(n_slots=2)),
    "eos": (eos, dict(n_slots=1)),
    "wave": (wave, dict(n_slots=4)),
    "mixed_buckets": (mixed_buckets, dict(n_slots=4, prefill_bucket=64)),
    "int8_cache": (interleaved, dict(n_slots=2, int8=True)),
    "quantum": (quantum_eos, dict(n_slots=2, decode_quantum=4)),
    "adaptive_quantum": (quantum_eos, dict(n_slots=2, decode_quantum=12, adaptive_quantum=True)),
    "chunked": (chunked, dict(n_slots=2, prefill_bucket=16, prefill_chunk=16)),
    "prefix": (prefix, dict(n_slots=2, prefix_cache_size=4)),
    "int8_prefix_chunked_quantum": (prefix, dict(n_slots=2, int8=True, prefix_cache_size=4,
                                                 prefill_chunk=8, decode_quantum=8)),
    "flash_route_2048": (long_prompts, dict(long=True, n_slots=2, int8=True)),
    "flash_route_2048_waves": (long_prompts, dict(long=True, n_slots=4, prefill_bucket=512,
                                                  decode_quantum=4)),
    "flash_route_2048_chunked": (long_prompts, dict(long=True, n_slots=2, prefill_chunk=128,
                                                    decode_quantum=4, adaptive_quantum=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_the_reference(case, monkeypatch):
    _set_ref_eos()
    scenario, kw = CASES[case]
    ref = scenario(_make("jax", **kw))
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain", lambda *a, **k: calls.append(1) or
                        plain(*a, **k))
    got = scenario(_make("torch", **kw))
    assert got == ref
    assert bool(calls) == kw.get("long", False)  # the flash route runs where it is eligible


def test_chunked_prefill_interleaves_with_decode():
    """A running request advances one token on every step of another
    request's chunked prefill."""
    b = _make("torch", n_slots=2, prefill_bucket=8, prefill_chunk=8)
    r1 = b.submit(np.asarray([3, 4, 5], np.int32), 20, return_request=True)
    b.step()
    b.submit(np.arange(1, 49, dtype=np.int32), 6)
    progress = []
    while b._prefilling or b.queue:
        before = len(r1.generated)
        b.step()
        progress.append(len(r1.generated) - before)
    assert len(progress) >= 6 and all(d == 1 for d in progress[:-1])


@pytest.mark.parametrize("cache", ["int8", "dense"])
def test_vector_position_writes_match_scalar(cache):
    """gpt.forward with per-row positions (B,) lands each row's KV at its own
    position, as the scalar path does one row at a time; logits agree with
    the JAX package's vector-position forward."""
    jp, tp = _params()
    cfg, jcfg = Config(**TINY), JaxConfig(**TINY)
    rng = np.random.default_rng(1)
    pre = rng.integers(1, 128, (2, 6)).astype(np.int32)
    toks = rng.integers(1, 128, (2, 3)).astype(np.int32)
    dt = torch.int8 if cache == "int8" else torch.float32
    with torch.inference_mode():
        base = gpt.init_kv_cache(cfg, 2, 64, dt, device="cpu")
        gpt.forward(tp, cfg, torch.from_numpy(pre), input_pos=0, kv_cache=base)
        want = {}
        for b, pos in ((0, 6), (1, 4)):
            row = {k: v[:, b:b + 1].clone() for k, v in base.items()}
            logits, _ = gpt.forward(tp, cfg, torch.from_numpy(toks[b:b + 1]), input_pos=pos,
                                    kv_cache=row)
            want[b] = (row, logits[0])
        got = {k: v.clone() for k, v in base.items()}
        logits, _ = gpt.forward(tp, cfg, torch.from_numpy(toks), input_pos=torch.tensor([6, 4]),
                                kv_cache=got)
    for b in (0, 1):
        for key in got:
            np.testing.assert_allclose(got[key][:, b].float().numpy(),
                                       want[b][0][key][:, 0].float().numpy(), atol=2e-5,
                                       rtol=2e-5, err_msg=f"{cache} leaf {key} row {b}")
        np.testing.assert_allclose(logits[b].numpy(), want[b][1].numpy(), atol=1e-4, rtol=0)
    jcache = jgpt.init_kv_cache(jcfg, 2, 64, jnp.int8 if cache == "int8" else jnp.float32)
    _, jcache = jgpt.forward(jp, jcfg, jnp.asarray(pre), input_pos=0, kv_cache=jcache)
    jlogits, _ = jgpt.forward(jp, jcfg, jnp.asarray(toks), input_pos=jnp.asarray([6, 4]),
                              kv_cache=jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


def test_top_k_sampling():
    """top_k=1 at any temperature is greedy (the JAX batcher's greedy
    tokens); every token sampled with top_k=5 lies in the top 5 of the
    port's own logits at its step; unrestricted hot sampling leaves greedy."""
    prompt = np.arange(1, 11, dtype=np.int32)
    jb = _make("jax", n_slots=1)
    rid = jb.submit(prompt, 10)
    greedy = jb.run_to_completion()[rid]
    b = _make("torch", n_slots=3)
    r1 = b.submit(prompt, 10, temperature=1.5, top_k=1)
    r2 = b.submit(prompt, 10, temperature=1.5, top_k=5)
    r3 = b.submit(prompt, 10, temperature=1.5)
    res = b.run_to_completion()
    assert res[r1] == greedy
    assert res[r3] != greedy
    _, tp = _params()
    seq = torch.from_numpy(np.concatenate([prompt, res[r2]]).astype(np.int32))[None]
    cfg = Config(**TINY)
    with torch.inference_mode():
        logits, _ = gpt.forward(tp, cfg, seq, input_pos=0,
                                kv_cache=gpt.init_kv_cache(cfg, 1, 128, device="cpu"))
    top5 = torch.topk(logits[0, len(prompt) - 1:-1], 5).indices
    assert all(tok in top5[i].tolist() for i, tok in enumerate(res[r2]))


@pytest.mark.parametrize("quantum", [1, 4])
def test_sampling_reproducible_from_a_seeded_generator(quantum):
    def run(seed):
        b = _make("torch", n_slots=2, decode_quantum=quantum,
                  generator=torch.Generator().manual_seed(seed))
        rids = [b.submit(p, 10, temperature=0.9, top_k=40) for p in _prompts(8, (7, 12))]
        res = b.run_to_completion()
        return [res[r] for r in rids]

    assert run(11) == run(11)
    assert run(11) != run(12)


def test_unported_options_raise():
    # speculative batching is ported (tests/test_torch_speculative_serving.py): it builds
    assert _make("torch", speculative_k=4)._headroom == 5
    # the mesh is ported (tests/test_torch_tp_serving.py runs it on gloo ranks): a Mesh only
    with pytest.raises(TypeError, match="Mesh"):
        _make("torch", mesh=object())
    _, tp = _params()
    # the linear arms are served (tests/test_torch_linear_serving.py): an O(1) state a slot
    linear = ContinuousBatcher(Config(**TINY, attn_alg="fastmax"), tp, n_slots=2, device="cpu")
    assert linear.cache["s_kkv"].shape == (TINY["n_layer"], 2, TINY["n_head"], 32 * 32, 32)
    rid = linear.submit(np.arange(1, 6, dtype=np.int32), 3)
    assert len(linear.run_to_completion()[rid]) == 3
    with pytest.raises(ValueError, match="quadratic"):
        ContinuousBatcher(Config(**TINY, attn_alg="fastmax"), tp, speculative_k=4, device="cpu")
    with pytest.raises(ValueError):
        _make("torch", decode_quantum=1, adaptive_quantum=True)
    with pytest.raises(ValueError, match="prefill_chunk must be >="):
        _make("torch", prefill_chunk=4, decode_quantum=8)
