"""Parity of the port's plain ops (fastmax_tpu_torch/ops) with the JAX
package's, on the CPU, from the same numpy-seeded inputs.

Tolerances: float32 results atol 1e-5; int8 codes equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.ops import attention as jattn
from fastmax_tpu.ops import norms as jnorms
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.ops import rope as jrope
from fastmax_tpu.ops import sampling as jsampling
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.ops import attention, norms, quant, rope, sampling

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
ATOL = 1e-5


def _close(got: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, unit_offset)
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, unit_offset), ref)


def test_layer_norm_and_apply_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3 + 1
    p = {"weight": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for kind in ("LayerNorm", "RMSNorm"):
        ref = jnorms.apply_norm(jnp.asarray(x), jp, kind, 1e-5)
        _close(norms.apply_norm(torch.from_numpy(x), tp, kind, 1e-5), ref)


@pytest.mark.parametrize("n_elem,condense", [(32, 1), (16, 2)])
def test_rope(n_elem, condense):
    jcos, jsin = jrope.build_rope_cache(24, n_elem, 10000, condense)
    cos, sin = rope.build_rope_cache(24, n_elem, 10000, condense)
    assert cos.dtype == torch.float32 and cos.shape == (24, n_elem)
    _close(cos, jcos)
    _close(sin, jsin)
    x = np.random.default_rng(2).standard_normal((2, 4, 24, n_elem)).astype(np.float32)
    _close(rope.apply_rope(torch.from_numpy(x), cos, sin),
           jrope.apply_rope(jnp.asarray(x), jcos, jsin))


def test_rope_bf16_promotes_then_casts_back():
    jcos, jsin = jrope.build_rope_cache(8, 16)
    cos, sin = rope.build_rope_cache(8, 16)
    x = np.random.default_rng(3).standard_normal((1, 2, 8, 16)).astype(np.float32)
    got = rope.apply_rope(torch.from_numpy(x).to(torch.bfloat16), cos, sin)
    ref = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jcos, jsin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_roundtrip(dtype):
    """Codes are equal; for bf16 the scale is divided in bf16 as in the
    reference, so the codes match only if the port does the same."""
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero row: scale 0, codes 0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jcodes, jscale = jgpt._quantize_kv(jx)
    codes, scale = gpt._quantize_kv(tx)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    deq = gpt._dequantize_kv(codes, scale, tx.dtype)
    jdeq = jgpt._dequantize_kv(jcodes, jscale, jx.dtype)
    np.testing.assert_array_equal(deq.float().numpy(), np.asarray(jdeq, np.float32))


@pytest.mark.parametrize("k,n", [(512, 1024), (192, 1100)])
def test_dequantize_q4r1(k, n):
    kernel = (np.random.default_rng(5).standard_normal((k, n)) * 0.05).astype(np.float32)
    jp = jquant.quantize_int4_tiled(kernel, "rank1")
    tp = {key: torch.from_numpy(np.array(v)) for key, v in jp.items()}
    got = quant.dequantize(tp)
    assert got.shape == (k, n)
    _close(got, jquant.dequantize(jp))


def test_repeat_kv_heads_and_softmax():
    x = np.random.default_rng(6).standard_normal((2, 2, 5, 8)).astype(np.float32)
    _close(attention.repeat_kv_heads(torch.from_numpy(x), 6),
           jattn.repeat_kv_heads(jnp.asarray(x), 6))
    s = np.random.default_rng(7).standard_normal((3, 9)).astype(np.float32)
    s[1] = -np.inf  # fully masked row
    got = attention.softmax_f32(torch.from_numpy(s))
    _close(got, jattn.jax_softmax_f32(jnp.asarray(s)))
    assert float(got[1].abs().sum()) == 0.0


@pytest.mark.parametrize("hq,g", [(4, 4), (4, 2), (4, 1)])
def test_scaled_dot_product_attention(hq, g):
    rng = np.random.default_rng(8)
    b, t, s, d = 2, 3, 10, 16
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, g, s, d)).astype(np.float32)
    v = rng.standard_normal((b, g, s, d)).astype(np.float32)
    mask = np.arange(s)[None, :] <= (4 + np.arange(t))[:, None]
    mask = np.broadcast_to(mask, (b, 1, t, s)).copy()
    mask[1, 0, 2] = False  # a fully masked query row gives 0, not NaN
    got = attention.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(mask), scale=0.3)
    ref = jattn.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask), scale=0.3)
    _close(got, ref)
    assert bool(torch.isfinite(got).all()) and float(got[1, :, 2].abs().sum()) == 0.0
    causal = attention.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    _close(causal, jattn.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), is_causal=True))


@pytest.mark.parametrize("hq,g", [(4, 2), (4, 1)])
def test_int8_cache_attention(hq, g):
    rng = np.random.default_rng(9)
    b, t, s, d = 2, 1, 16, 32
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    kc, vc = (rng.integers(-127, 128, (b, g, s, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (b, g, s)).astype(np.float32) for _ in range(2))
    mask = (np.arange(s)[None, :] <= np.array([[11], [3]]))[:, None, None, :]
    got = attention.int8_cache_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, ks, vs)), mask=torch.from_numpy(mask),
        scale=d ** -0.5)
    ref = jattn.int8_cache_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, ks, vs)), mask=jnp.asarray(mask),
        scale=d ** -0.5)
    _close(got, ref)


def test_greedy_sample():
    logits = np.random.default_rng(10).standard_normal((3, 50)).astype(np.float32)
    logits[2, [7, 9]] = 10.0  # a tie takes the first index in both
    got = sampling.sample(torch.from_numpy(logits))
    ref = jsampling.sample(jnp.asarray(logits), None, 0.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # sampled with the top-1 filter: the argmax again, whatever the noise
    hot = sampling.sample(torch.from_numpy(logits[:2]), temperature=1.0, top_k=1,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(hot, got[:2])
