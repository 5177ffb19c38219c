"""The slice as a whole: the port's InferenceEngine.generate gives the same
greedy tokens as fastmax_tpu.inference.engine.InferenceEngine.generate, with
the same rank-1 int4 weights, for the int8 and the dense KV cache, with and
without chunked prefill.

Each step's top-2 logit margin is computed along the JAX sequence with the
port's own forward, so that a divergence is reported as a near-tie or as a
fault (ROADMAP queue C, "Near-ties")."""

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
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False, parallel_residual=False)  # as Llama-2
NEAR_TIE = 1e-4
PROMPT, NEW = 8, 24


@functools.lru_cache(maxsize=None)
def _params():
    dense = jgpt.init_params(JaxConfig(**TINY), jax.random.PRNGKey(0), jnp.float32)
    tree = JaxEngine.prepare_params(jquant.quantize_model(dense, "bnb.nf4"), "preload_int4")
    return tree, from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


def _margins(engine: InferenceEngine, seq: np.ndarray) -> np.ndarray:
    """Top-2 logit margin of the port at each generated position of ``seq``."""
    cache = engine.new_cache()
    with torch.inference_mode():
        logits, cache = engine._forward(torch.from_numpy(seq[:, :PROMPT]), cache, 0)
        rows = [logits[0, -1]]
        for pos in range(PROMPT, seq.shape[1] - 1):
            logits, cache = engine._forward(torch.from_numpy(seq[:, pos:pos + 1]), cache, pos)
            rows.append(logits[0, -1])
    top2 = torch.topk(torch.stack(rows).float(), 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


@pytest.mark.parametrize("chunk", [512, 4])
@pytest.mark.parametrize("cache", ["int8", "dense"])
def test_greedy_tokens_identical(cache, chunk):
    jp, tp = _params()
    prompt = np.random.default_rng(0).integers(1, 128, (PROMPT,)).astype(np.int32)
    jeng = JaxEngine(JaxConfig(**TINY), jp, max_seq_length=64, weights_mode="quantized",
                     cache_dtype=jnp.int8 if cache == "int8" else None)
    teng = InferenceEngine(Config(**TINY), tp, max_seq_length=64, weights_mode="quantized",
                           cache_dtype=torch.int8 if cache == "int8" else None, device="cpu")
    jeng.PREFILL_CHUNK = teng.PREFILL_CHUNK = chunk
    ref = np.array(jeng.generate(jnp.asarray(prompt), PROMPT + NEW, temperature=0.0,
                                   key=jax.random.PRNGKey(0)))
    got = teng.generate(torch.from_numpy(prompt), PROMPT + NEW, temperature=0.0).numpy()
    assert got.shape == ref.shape == (1, PROMPT + NEW)
    margins = _margins(teng, ref)
    diff = np.nonzero(got[0, PROMPT:] != ref[0, PROMPT:])[0]
    if diff.size:
        i = int(diff[0])
        kind = "a near-tie" if margins[i] < NEAR_TIE else "not a near-tie: a fault"
        pytest.fail(f"tokens diverge at generated step {i}: port top-2 margin "
                    f"{margins[i]:.2e} ({kind})")
    np.testing.assert_array_equal(got, ref)


def test_eos_truncates():
    _, tp = _params()
    teng = InferenceEngine(Config(**TINY), tp, max_seq_length=64, weights_mode="quantized",
                           cache_dtype=torch.int8, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(1, 128, (PROMPT,)))
    full = teng.generate(prompt, PROMPT + NEW)
    eos = int(full[0, PROMPT + 3])
    cut = teng.generate(prompt, PROMPT + NEW, eos_id=eos)
    first = int(np.nonzero(full[0, PROMPT:].numpy() == eos)[0][0])
    assert torch.equal(cut, full[:, :PROMPT + first + 1])


def test_unported_modes_raise():
    """Every weights mode of the reference is ported (tests/test_torch_quant_serving.py);
    an unknown one raises. A linear arm is served through its running state
    (tests/test_torch_linear_serving.py holds its tokens against the JAX engine)."""
    _, tp = _params()
    with pytest.raises(ValueError, match="weights_mode"):
        InferenceEngine(Config(**TINY), tp, weights_mode="preload_int3", device="cpu")
    teng = InferenceEngine(Config(**TINY, attn_alg="fastmax"), tp, device="cpu")
    assert set(teng.new_cache()) == {"cnt", "s_v", "s_kv", "s_k", "s_kkv", "s_kk"}
    out = teng.generate(torch.arange(1, 5), 8)
    assert out.shape == (1, 8) and out[0, :4].tolist() == [1, 2, 3, 4]
