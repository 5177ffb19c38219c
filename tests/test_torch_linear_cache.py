"""``gpt.forward_linear_cache`` and the cached ``gpt.forward`` with a linear
arm in the port against the JAX package on the CPU, float32: two slots
prefilled one by one into a bucket (``n_valid``) and decoded at per-slot
positions, a decode step continuing the prefill of the longer prompt, and
the reference's dense-cache semantics. States are compared on the entries
each arm reads (``tests/test_torch_linear_decode.py``).

The reference's decode fault at partial RoPE. The JAX package rotates q and
k by ``x.at[..., :nre].set(apply_rope(x[..., :nre], cos, sin))``. Compiled
in its single-token step (``forward_linear_cache`` at T = 1, which the
engine's and the batcher's decode run), XLA's CPU compile gives the second
half of the rotated dims wrong values: k at position 2 is off by up to 0.8,
and its decode disagrees with its own prefill of the longer prompt
(``test_decode_continues_the_prefill_of_the_longer_prompt`` holds the port
to that prefill). The same JAX code run eagerly agrees with the prefill, so
every JAX decode step at partial RoPE here runs under ``jax.disable_jit()``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from tests.test_torch_linear_decode import held, held_state

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)

LOGITS_ATOL = 1e-4
# tests/test_quant_pallas.py's small LLaMA, with grouped heads (partial RoPE: 8 of 32 dims)
LIN = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
           n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
           _mlp_class="LLaMAMLP", bias=False)
ALGS = ("fastmax", "fastmax_cuda", "linearmax", "performer")


@functools.lru_cache(maxsize=None)
def _params():
    dense = jgpt.init_params(JaxConfig(**LIN), jax.random.PRNGKey(0), jnp.float32)
    return dense, from_numpy_params(jax.tree.map(np.asarray, dense), "cpu")


def _cfgs(alg):
    return JaxConfig(**LIN, attn_alg=alg), Config(**LIN, attn_alg=alg)


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(1, 128, (n,)).astype(np.int32)


@pytest.mark.parametrize("alg", ALGS)
def test_forward_linear_cache_matches_jax(alg):
    """Two slots prefilled one by one into a 16-token bucket (11 and 16 real
    tokens, ``n_valid``), then 8 decode steps at per-slot positions."""
    jc, tc = _cfgs(alg)
    jp, tp = _params()
    lens, bucket = (11, 16), 16
    js = jgpt.init_linear_cache(jc, 2)
    ts = gpt.init_linear_cache(tc, 2, device="cpu")
    for r, n in enumerate(lens):
        tokens = np.zeros(bucket, np.int32)
        tokens[:n] = _tokens(r, n)
        jl, jrow = jgpt.forward_linear_cache(jp, jc, jnp.asarray(tokens)[None],
                                             state=jgpt.init_linear_cache(jc, 1), input_pos=0,
                                             is_prefill=True, n_valid=jnp.asarray(n))
        js = {k: v.at[:, r:r + 1].set(jrow[k]) for k, v in js.items()}
        row = {k: v[:, r:r + 1] for k, v in ts.items()}
        tl, _ = gpt.forward_linear_cache(tp, tc, torch.from_numpy(tokens)[None], state=row,
                                         input_pos=0, is_prefill=True, n_valid=n)
        np.testing.assert_allclose(tl[:, :n].numpy(), np.asarray(jl)[:, :n], atol=LOGITS_ATOL,
                                   rtol=0)
    held_state(alg, {k: v for k, v in ts.items()}, js)
    assert ts["cnt"][:, 0].eq(11).all() and ts["cnt"][:, 1].eq(16).all()
    pos = np.array(lens, np.int32)
    rng = np.random.default_rng(7)
    for _ in range(8):
        tok = rng.integers(1, 128, (2, 1)).astype(np.int32)
        with jax.disable_jit():  # the reference's compiled step at partial RoPE: module doc
            jl, js = jgpt.forward_linear_cache(jp, jc, jnp.asarray(tok), state=js,
                                               input_pos=jnp.asarray(pos))
        tl, ts = gpt.forward_linear_cache(tp, tc, torch.from_numpy(tok), state=ts,
                                          input_pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
        pos = pos + 1
    held_state(alg, ts, js)


@pytest.mark.parametrize("alg", ["fastmax", "performer"])
def test_decode_continues_the_prefill_of_the_longer_prompt(alg):
    """The port's prefill of 11 tokens and one step at position 11 leave the
    state that the reference's prefill of the 12 tokens leaves (the
    reference's own compiled step does not: module doc)."""
    jc, tc = _cfgs(alg)
    jp, tp = _params()
    seq = _tokens(3, 12)
    _, want = jgpt.forward_linear_cache(jp, jc, jnp.asarray(seq)[None],
                                        state=jgpt.init_linear_cache(jc, 1), input_pos=0,
                                        is_prefill=True)
    state = gpt.init_linear_cache(tc, 1, device="cpu")
    gpt.forward_linear_cache(tp, tc, torch.from_numpy(seq[:11])[None], state=state, input_pos=0,
                             is_prefill=True)
    gpt.forward_linear_cache(tp, tc, torch.from_numpy(seq[11:])[None], state=state, input_pos=11)
    held_state(alg, state, want)


@pytest.mark.parametrize("alg", ["fastmax", "linearmax", "performer"])
def test_cached_forward_over_a_dense_cache_matches_jax(alg):
    """The reference's semantics over a padded KV cache (fastmax and linearmax
    unmasked over the whole cache, performer over its first T positions): a
    9-token prefill, then two single-token steps."""
    jc, tc = _cfgs(alg)
    jp, tp = _params()
    seq = _tokens(5, 11)
    jcache = jgpt.init_kv_cache(jc, 1, 32)
    tcache = gpt.init_kv_cache(tc, 1, 32, device="cpu")
    for p0, p1 in ((0, 9), (9, 10), (10, 11)):
        jl, jcache = jgpt.forward(jp, jc, jnp.asarray(seq[p0:p1])[None], input_pos=p0,
                                  kv_cache=jcache)
        tl, tcache = gpt.forward(tp, tc, torch.from_numpy(seq[p0:p1])[None], input_pos=p0,
                                 kv_cache=tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
    held("the dense cache's k", tcache["k"], jcache["k"])
