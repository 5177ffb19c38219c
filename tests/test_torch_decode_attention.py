"""The port's int8 decode attention (fastmax_tpu_torch/ops/decode_attention.py)
against the Pallas kernels of fastmax_tpu/ops/decode_attention.py in
interpret mode, and against the port's own int8_cache_attention; and an
emulation of the CUDA kernel's split over the cache positions, in plain
PyTorch, against both.

Tolerances: max-abs 2e-2 with bf16 q (tests/test_decode_attention.py);
1e-4 with f32 q; the split's bf16 mean error over the mean |plain| under
chip_smoke.ATTN_BF16_MEAN (5e-5), the gate phase 4 holds the kernel to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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
    """The route takes exactly the reference's conditions, for any number of
    query rows a group (the split route holds no whole softmax row in shared
    memory)."""
    for t in (1, 2):
        for d in (32, 64, 96, 128, 256):
            for s in (128, 256, 1000, 1024, 4096, 16384, 32768, 65536):
                for r in (1, 4, 8, 32):
                    assert da.int8_decode_eligible(t, d, s, r) == jda.int8_decode_eligible(t, d, s)


def _split_emulation(q, kc, vc, ks, vs, pos, scale: float, nsplit: int, local: bool = False):
    """The CUDA kernel's split route in plain PyTorch. Each chunk of
    split_chunk(S, nsplit) positions gives its max m_i and sum l_i of
    exp(s - m_i); a row's m and l come from them in split order; p =
    exp(s - m) / l times v_scale is rounded to q's dtype; the chunks' partial
    outputs are summed in split order. ``local``: flash-decoding's usual form
    instead, p rounded against the chunk's own m_i and l_i and the partial then
    rescaled by l_i exp(m_i - m) / l (another function than the reference's)."""
    b, hq, _, d = q.shape
    g, s = kc.shape[1], kc.shape[2]
    chunk = da.split_chunk(s, nsplit)
    qg = q.reshape(b, g, hq // g, d).float()
    sc = torch.einsum("bgrd,bgsd->bgrs", qg, kc.to(q.dtype).float())
    sc = sc * (scale * ks.float())[:, :, None, :]
    out = torch.zeros(b, g, hq // g, d)
    for bi in range(b):
        n = max(0, min(int(pos[bi]) + 1, s))
        chunks = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
        stats = []
        for lo, hi in chunks:
            m_i = sc[bi, :, :, lo:hi].amax(-1)
            stats.append((m_i, torch.exp(sc[bi, :, :, lo:hi] - m_i[..., None]).sum(-1)))
        if not stats:
            continue
        m = torch.stack([m_i for m_i, _ in stats]).amax(0)
        l = torch.zeros_like(m)
        for m_i, l_i in stats:
            l = l + l_i * torch.exp(m_i - m)
        for (lo, hi), (m_i, l_i) in zip(chunks, stats):
            e = torch.exp(sc[bi, :, :, lo:hi] - (m_i if local else m)[..., None])
            p = e / (l_i if local else l)[..., None]
            pv = (p * vs[bi, :, None, lo:hi].float()).to(q.dtype).float()
            part = torch.einsum("grs,gsd->grd", pv, vc[bi, :, lo:hi].to(q.dtype).float())
            if local:
                part = part * (l_i * torch.exp(m_i - m) / l)[..., None]
            out[bi] = out[bi] + part
    return out.to(q.dtype).reshape(b, hq, 1, d)


def _mean_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().mean() / ref.abs().mean())


# phase 4's bf16 cases (B, Hq, G, S, D, position vectors), at the split route it checks
_PHASE4_BF16 = [c[:5] + c[6:] for c in chip_smoke.attn_cases(torch, da) if c[5] == torch.bfloat16]


@pytest.mark.parametrize("case", _PHASE4_BF16, ids=[f"B{c[0]}-G{c[2]}-S{c[3]}-D{c[4]}-{i}"
                                                    for i, c in enumerate(_PHASE4_BF16)])
def test_split_schedule_matches_pallas_and_plain(case):
    """The split route (global max and sum before the rounding) at phase 4's
    bf16 cases and positions, emulated in plain PyTorch, lies within the max
    gate of the JAX kernel in interpret mode (4.9e-4 at most at these seeds)
    and within the mean gate of the plain version (1.9e-6 of the mean |plain|
    at most)."""
    b, hq, g, s, d, positions = case
    q, kc, vc, ks, vs = _inputs((1,), b, hq, g, s, d, seed=s + b + g)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk = [torch.from_numpy(a[0]) for a in (kc, vc, ks, vs)]
    nsplit = chip_smoke.attn_split_route(da, b, hq, g, s, d)
    for slots in positions:
        pos = np.array(slots, np.int32)
        ref = jda.int8_decode_attention_stacked(
            jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(a) for a in (kc, vc, ks, vs)),
            jnp.int32(0), jnp.asarray(pos), scale=d ** -0.5, interpret=True)
        got = _split_emulation(tq, *tk, torch.from_numpy(pos), d ** -0.5, nsplit)
        plain = da.int8_decode_attention_plain(tq, *tk, torch.from_numpy(pos), scale=d ** -0.5)
        assert _err(got, ref) < TOL["bfloat16"], slots
        assert _mean_err(got, plain) <= chip_smoke.ATTN_BF16_MEAN, slots


@pytest.mark.parametrize("b,s,slots", [(1, 1024, (1023,)), (8, 4096, (3000,) * 8)])
def test_split_local_rounding_fails_the_mean_gate(b, s, slots):
    """Why phase 4 holds bf16 outputs by their mean error too. At phase 4's
    input law, batch 1 at pos 1023 (16 chunks of 64) and the serving shape at
    pos 3000 (12 chunks of 256), p * v_scale rounded against each chunk's own
    max and sum (flash-decoding's form) moves the output by 9.8e-4 at most, far
    inside the 2e-2 max gate, and by 2.2e-3 and 2.3e-3 of the mean |plain| at
    seed 0: 44 and 46 times the mean gate. The split done right stays under a
    fifth of the gate."""
    q, kc, vc, ks, vs = _inputs((), b, 32, 32, s, 128, seed=0)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk = [torch.from_numpy(a) for a in (kc, vc, ks, vs)]
    pos = torch.tensor(slots, dtype=torch.int32)
    nsplit = chip_smoke.attn_split_route(da, b, 32, 32, s, 128)
    plain = da.int8_decode_attention_plain(tq, *tk, pos, scale=128 ** -0.5)
    local = _split_emulation(tq, *tk, pos, 128 ** -0.5, nsplit, local=True)
    right = _split_emulation(tq, *tk, pos, 128 ** -0.5, nsplit)
    assert _err(local, plain.float().numpy()) <= chip_smoke.ATTN_MAX_ABS
    assert _mean_err(local, plain) >= 40 * chip_smoke.ATTN_BF16_MEAN
    assert _mean_err(right, plain) <= chip_smoke.ATTN_BF16_MEAN / 5


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
