"""The port's int8 decode attention (fastmax_tpu_torch/ops/decode_attention.py)
against the Pallas kernels of fastmax_tpu/ops/decode_attention.py in
interpret mode, and against the port's own int8_cache_attention.

Tolerances: max-abs 2e-2 with bf16 q (tests/test_decode_attention.py);
1e-4 with f32 q."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.ops import decode_attention as jda
from fastmax_tpu_torch.ops import attention, decode_attention as da

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _inputs(lead, b, hq, g, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    kc = rng.integers(-127, 128, lead + (b, g, s, d)).astype(np.int8)
    vc = rng.integers(-127, 128, lead + (b, g, s, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, lead + (b, g, s)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, lead + (b, g, s)).astype(np.float32)
    return q, kc, vc, ks, vs


def _err(got: torch.Tensor, ref) -> float:
    return float(np.max(np.abs(got.float().numpy() - np.asarray(ref, np.float32))))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,g", [(8, 8), (8, 4), (8, 1)])  # MHA, GQA, MQA
def test_plain_matches_pallas(hq, g, d, dtype):
    b, s = 2, 256
    q, kc, vc, ks, vs = _inputs((), b, hq, g, s, d, seed=hq + g + d)
    pos = np.array([s - 1, 37], np.int32)
    ref = jda.int8_decode_attention(
        jnp.asarray(q, getattr(jnp, dtype)), *(jnp.asarray(a) for a in (kc, vc, ks, vs)),
        jnp.asarray(pos), scale=d ** -0.5, interpret=True)
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    got = da.int8_decode_attention(tq, *(torch.from_numpy(a) for a in (kc, vc, ks, vs)),
                                   torch.from_numpy(pos), scale=d ** -0.5)
    assert got.dtype == tq.dtype and got.shape == (b, hq, 1, d)
    assert _err(got, ref) < TOL[dtype]
    # the port's scale-on-scores formulation agrees too
    mask = torch.arange(s)[None, None, None, :] <= torch.from_numpy(pos)[:, None, None, None]
    alt = attention.int8_cache_attention(tq, *(torch.from_numpy(a) for a in (kc, vc, ks, vs)),
                                         mask=mask, scale=d ** -0.5)
    assert _err(alt, np.asarray(got.float())) < TOL[dtype]


@pytest.mark.parametrize("hq,g,layer", [(8, 4, 0), (8, 4, 2), (4, 1, 1)])
def test_stacked_matches_pallas(hq, g, layer):
    b, s, d, n_layer = 2, 128, 64, 3
    q, kc, vc, ks, vs = _inputs((n_layer,), b, hq, g, s, d, seed=layer)
    pos = np.array([100, 55], np.int32)
    ref = jda.int8_decode_attention_stacked(
        jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(a) for a in (kc, vc, ks, vs)),
        jnp.int32(layer), jnp.asarray(pos), scale=d ** -0.5, interpret=True)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk = [torch.from_numpy(a) for a in (kc, vc, ks, vs)]
    got = da.int8_decode_attention_stacked(tq, *tk, layer, torch.from_numpy(pos),
                                           scale=d ** -0.5)
    assert _err(got, ref) < 2e-2
    per = da.int8_decode_attention(tq, *(a[layer] for a in tk), torch.from_numpy(pos),
                                   scale=d ** -0.5)
    assert torch.equal(got, per)


def test_scalar_pos_and_first_position():
    """pos as a Python int; pos 0 attends to slot 0 only."""
    q, kc, vc, ks, vs = _inputs((), 1, 4, 2, 128, 64, seed=11)
    tq = torch.from_numpy(q)
    tk = [torch.from_numpy(a) for a in (kc, vc, ks, vs)]
    got = da.int8_decode_attention(tq, *tk, 0, scale=0.125)
    # softmax over one slot is 1: out = v_scale[0] * v_codes[0]
    ref = (tk[3][:, :, 0, None] * tk[1][:, :, 0].float())  # (B, G, D)
    ref = ref.repeat_interleave(2, dim=1)[:, :, None, :]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_eligibility():
    assert da.int8_decode_eligible(1, 128, 1024)
    assert da.int8_decode_eligible(1, 64, 256, r=8)
    assert not da.int8_decode_eligible(2, 128, 1024)
    assert not da.int8_decode_eligible(1, 96, 1024)
    assert not da.int8_decode_eligible(1, 128, 1000)
    assert not da.int8_decode_eligible(1, 128, 16384, r=8)  # softmax row exceeds shared memory


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hq,g,d", [(32, 32, 128), (8, 2, 128), (8, 1, 64)])
def test_cuda_kernel_matches_plain(cuda_device, hq, g, d, dtype):
    q, kc, vc, ks, vs = _inputs((3,), 2, hq, g, 512, d, seed=3)
    tq = torch.from_numpy(q).to(getattr(torch, dtype)).to(cuda_device)
    tk = [torch.from_numpy(a).to(cuda_device) for a in (kc, vc, ks, vs)]
    pos = torch.tensor([511, 17], dtype=torch.int32, device=cuda_device)
    got = da.int8_decode_attention_stacked(tq, *tk, 2, pos, scale=d ** -0.5)
    ref = da.int8_decode_attention_stacked(tq, *tk, 2, pos, scale=d ** -0.5, plain=True)
    torch.cuda.synchronize()
    assert _err(got.cpu(), ref.cpu().float().numpy()) < TOL[dtype]
