"""The port's token sampling (fastmax_tpu_torch/ops/sampling.py) and sampled
InferenceEngine.generate. The noise comes from a torch.Generator, whose bits
differ from jax.random's, so the draws are held to the distribution the JAX
package defines (filtered_log_probs, compared directly) and to greedy where
the filter leaves one token; on the CPU, in float32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.ops import sampling as jsampling
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.ops import sampling

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
V = 16
N_DRAWS = 20000
FREQ_ATOL = 0.015  # 5 standard deviations of a frequency near 1/4 over 20000 draws
TINY = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False, parallel_residual=False)


def _logits(seed=0, rows=1):
    return np.random.default_rng(seed).standard_normal((rows, V)).astype(np.float32) * 2


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("temperature,top_k", [(1.0, None), (0.7, 5), (1.5, 3)])
def test_filtered_log_probs_match_reference(temperature, top_k):
    x = _logits(1, 4)
    ref = np.asarray(jsampling.filtered_log_probs(jnp.asarray(x), temperature, top_k))
    got = sampling.filtered_log_probs(torch.from_numpy(x), temperature, top_k).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("temperature,top_k", [(1.0, None), (0.7, 5)])
def test_sample_draws_the_reference_distribution(temperature, top_k):
    x = np.repeat(_logits(2), N_DRAWS, axis=0)
    tok = sampling.sample(torch.from_numpy(x), temperature, top_k, generator=_gen(0)).numpy()
    freq = np.bincount(tok, minlength=V) / N_DRAWS
    want = np.exp(np.asarray(jsampling.filtered_log_probs(jnp.asarray(x[:1]), temperature,
                                                          top_k)))[0]
    assert np.abs(freq - want).max() <= FREQ_ATOL
    if top_k is not None:  # the support is the top_k tokens and nothing else
        assert set(np.nonzero(freq)[0]) <= set(np.argsort(x[0])[-top_k:])


def test_greedy_and_top1_are_the_argmax():
    x = torch.from_numpy(_logits(3, 8))
    want = torch.argmax(x, dim=-1).to(torch.int32)
    assert torch.equal(sampling.sample(x), want)
    assert torch.equal(sampling.sample(x, 0.0, 4), want)
    assert torch.equal(sampling.sample(x, 2.0, 1, generator=_gen(0)), want)
    ref = np.asarray(jsampling.sample(jnp.asarray(x.numpy()), jax.random.PRNGKey(0), 0.0))
    np.testing.assert_array_equal(sampling.sample(x).numpy(), ref)


def test_sample_traced_per_row_settings():
    x = torch.from_numpy(_logits(4, 6))
    greedy = torch.argmax(x, dim=-1).to(torch.int32)
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0, 1.0, 0.5])
    topk = torch.tensor([V, 1, 3, 1, V, 2])
    got = sampling.sample_traced(x, temps, topk, generator=_gen(0))
    assert got[[0, 2]].tolist() == greedy[[0, 2]].tolist()  # temperature 0
    assert got[[1, 3]].tolist() == greedy[[1, 3]].tolist()  # top-1
    assert int(got[5]) in torch.topk(x[5], 2).indices.tolist()
    # the all-greedy shortcut, and the draw reproducible from a seed
    assert torch.equal(sampling.sample_traced(x, temps * 0, topk, hot=False), greedy)
    assert torch.equal(sampling.sample_traced(x, temps, topk, generator=_gen(7)),
                       sampling.sample_traced(x, temps, topk, generator=_gen(7)))


@functools.lru_cache(maxsize=None)
def _engine():
    dense = jgpt.init_params(JaxConfig(**TINY), jax.random.PRNGKey(0), jnp.float32)
    tree = JaxEngine.prepare_params(jquant.quantize_model(dense, "bnb.nf4"), "preload_int4")
    tp = from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")
    return InferenceEngine(Config(**TINY), tp, max_seq_length=64, weights_mode="quantized",
                           cache_dtype=torch.int8, device="cpu")


def test_sampled_generate_is_reproducible_and_top1_is_greedy():
    eng = _engine()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(1, 128, (8,)))
    greedy = eng.generate(prompt, 32)
    assert torch.equal(eng.generate(prompt, 32, temperature=1.3, top_k=1, generator=_gen(1)),
                       greedy)
    a = eng.generate(prompt, 32, temperature=1.0, top_k=20, generator=_gen(5))
    b = eng.generate(prompt, 32, temperature=1.0, top_k=20, generator=_gen(5))
    assert torch.equal(a, b) and a.shape == (1, 32)
    assert not torch.equal(a, greedy)
