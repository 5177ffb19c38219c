"""Logits parity of the port's cached forward (fastmax_tpu_torch/models/gpt.py)
with fastmax_tpu.models.gpt.forward on the CPU: the same weights (the JAX
package's rank-1 int4 serving tree, brought over by from_numpy_params), the
same tokens, prefill of 8 tokens then 4 single-token decode steps, for the
int8 and the dense cache, with the sequential residual of Llama-2 and the
parallel one, in float32. Tolerance: atol 1e-4."""

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
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
ATOL = 1e-4
TINY = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False)
S = 64


@functools.lru_cache(maxsize=None)
def _params(kind: str, parallel_residual: bool = True):
    cfg = JaxConfig(**TINY, parallel_residual=parallel_residual)
    dense = jgpt.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    if kind == "int4":
        tree = JaxEngine.prepare_params(jquant.quantize_model(dense, "bnb.nf4"), "preload_int4")
    else:
        tree = dense
    return tree, from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


def test_int4_tree_layout():
    _, tp = _params("int4")
    mlp = tp["blocks"]["mlp"]
    assert set(mlp) == {"fc_12", "proj"}
    assert tuple(mlp["fc_12"]["q4r1"].shape) == (2, 1, 1, 512, 128)
    assert mlp["fc_12"]["q4r1"].dtype == torch.int32
    assert tuple(mlp["fc_12"]["v4"].shape) == (2, 512)
    assert tuple(tp["lm_head"]["kernel"].shape) == (128, 128)


@pytest.mark.parametrize("residual", ["sequential", "parallel"])
@pytest.mark.parametrize("kind", ["int4", "dense"])
@pytest.mark.parametrize("cache", ["int8", "dense"])
def test_forward_prefill_then_decode(kind, cache, residual):
    parallel = residual == "parallel"
    jcfg = JaxConfig(**TINY, parallel_residual=parallel)
    cfg = Config(**TINY, parallel_residual=parallel)
    jp, tp = _params(kind, parallel)
    jcache = jgpt.init_kv_cache(jcfg, 1, S, jnp.int8 if cache == "int8" else jnp.float32)
    tcache = gpt.init_kv_cache(cfg, 1, S, torch.int8 if cache == "int8" else torch.float32,
                               device="cpu")
    jfwd = jax.jit(lambda p, idx, pos, c: jgpt.forward(p, jcfg, idx, input_pos=pos,
                                                       kv_cache=c, max_seq_length=S))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 128, (1, 12)).astype(np.int32)
    steps = [(0, 8)] + [(p, 1) for p in range(8, 12)]
    for pos, t in steps:
        idx = tokens[:, pos:pos + t]
        jlogits, jcache = jfwd(jp, jnp.asarray(idx), jnp.int32(pos), jcache)
        with torch.inference_mode():
            logits, tcache = gpt.forward(tp, cfg, torch.from_numpy(idx), input_pos=pos,
                                         kv_cache=tcache, max_seq_length=S)
        assert logits.shape == (1, t, 128)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0,
                                   err_msg=f"pos {pos}")
    for key in jcache:
        got, ref = tcache[key].numpy(), np.asarray(jcache[key])
        if key in ("k", "v") and cache == "int8":
            # codes may differ by one step where x/scale sits on a rounding edge
            assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
