"""The port's flash prefill attention (fastmax_tpu_torch/ops/flash_attention.py)
against fastmax_tpu.ops.flash_attention.flash_attention in interpret mode on
the CPU, on the same numpy inputs: causal GQA/MQA, a query chunk at an
offset over a padded cache, kv_len cutting the last rows' keys, ragged T.

Tolerances: float32 atol 2e-5, rtol 1e-4 (the reference's own,
tests/test_flash_attention.py); bfloat16 atol 1e-2, one bf16 ulp (2^-7) of
outputs up to 2 with room for one rounding of p that falls the other way.
The card-only test holds the CUDA kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.ops.flash_attention import flash_attention as jax_flash
from fastmax_tpu.ops.flash_attention import flash_eligible as jax_eligible
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import flash_attention as fa

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
F32 = dict(atol=2e-5, rtol=1e-4)
BF16_ATOL = 1e-2


def _inputs(seed, b, hq, g, t, s, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, t, d)).astype(np.float32),
            rng.standard_normal((b, g, s, d)).astype(np.float32),
            rng.standard_normal((b, g, s, d)).astype(np.float32))


def _both(q, k, v, dtype=torch.float32, **kw):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)), interpret=True, **kw)
    got = fa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **kw)
    assert got.dtype == dtype and got.shape == q.shape
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("hq,g", [(4, 4), (8, 2), (4, 1)])
def test_causal_matches_reference(hq, g):
    got, ref = _both(*_inputs(0, 2, hq, g, 256, 256))
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("pos0,kv_len,s", [(128, 256, 512), (256, 320, 512), (0, 128, 2048)])
def test_offset_chunk_over_padded_cache(pos0, kv_len, s):
    """A 128-row chunk at pos0 over an S-row cache whose rows from kv_len on
    are padding (zeroed as in a real cache); kv_len < pos0 + T cuts the
    keys of the chunk's last rows; the rows of the cache before pos0 are
    the earlier prompt, attended by every query row."""
    q, k, v = _inputs(1, 1, 4, 2, 128, s)
    k[:, :, kv_len:] = 0
    v[:, :, kv_len:] = 0
    got, ref = _both(q, k, v, pos0=pos0, kv_len=kv_len)
    np.testing.assert_allclose(got, ref, **F32)


def test_bfloat16_rounds_p_per_block():
    q, k, v = _inputs(2, 1, 4, 2, 256, 512)
    got, ref = _both(q, k, v, torch.bfloat16, pos0=128, kv_len=384)
    assert np.abs(got - ref).max() <= BF16_ATOL


def test_ragged_rows_match_the_padded_call():
    """The kernel's way (T real rows) equals the reference's (T padded to
    the 128-row block, the padding sliced off)."""
    q, k, v = _inputs(3, 1, 4, 2, 200, 512)
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), pos0=100,
                             kv_len=300).numpy()
    qp = np.pad(q, ((0, 0), (0, 0), (0, 56), (0, 0)))
    ref = np.asarray(jax_flash(jnp.asarray(qp), jnp.asarray(k), jnp.asarray(v), pos0=100,
                               kv_len=300, interpret=True))[:, :, :200]
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_heads_match_reference(d):
    """Head sizes 192 and 256 (eligible by the reference's D % 64) take the
    same route and give the reference's result."""
    got, ref = _both(*_inputs(4, 1, 4, 2, 128, 256, d=d), pos0=64, kv_len=192)
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("t,s,d", [(128, 2048, 64), (256, 4096, 128), (128, 1024, 128),
                                   (100, 2048, 128), (128, 2048, 96), (128, 2048, 256),
                                   (128, 2048, 192), (128, 2048, 320)])
def test_eligibility(t, s, d):
    """The route takes exactly the reference's conditions."""
    assert fa.flash_eligible(t, s, d) == jax_eligible(t, s, d)


def test_unbuilt_head_size_raises_before_launch():
    """A head size the kernel is not built for raises NotImplementedError on
    the kernel's route instead of falling back to a plain version."""
    q, k, v = (torch.zeros(shape) for shape in ((1, 2, 128, 320), (1, 2, 2048, 320),
                                                (1, 2, 2048, 320)))
    with pytest.raises(NotImplementedError, match="320"):
        fa._launch(q, k, v, 320 ** -0.5, 0, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, hq, g, t, s, d, pos0 in ((1, 32, 32, 512, 4096, 128, 1536), (2, 8, 2, 200, 2048, 64, 0),
                                    (1, 8, 4, 256, 2048, 192, 512), (1, 8, 8, 130, 2048, 256, 100)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, hq, t, d), (b, g, s, d), (b, g, s, d)))
        before = build.KERNELS["flash_attention"].launches
        got = fa.flash_attention(q, k, v, pos0=pos0, kv_len=pos0 + t)
        ref = fa.flash_attention_plain(q, k, v, pos0=pos0, kv_len=pos0 + t)
        torch.cuda.synchronize()
        assert build.KERNELS["flash_attention"].launches == before + 1
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= (BF16_ATOL if dtype == torch.bfloat16 else 2e-5), err
