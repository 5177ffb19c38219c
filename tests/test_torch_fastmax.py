"""The port's fastmax scan (fastmax_tpu_torch/ops/fastmax_kernels.py and
ops/fastmax.py) against the JAX package's Pallas kernels in interpret mode on
the CPU, on the same numpy inputs: the forward, its normaliser and final state,
and the gradients of the reverse walk.

Tolerances are the reference's own (tests/test_fastmax_pallas.py): forward
atol 2e-4, rtol 1e-3; gradients atol 5e-4, rtol 2e-3; the 16-chunk walk 5e-3
of the largest gradient; bfloat16 4e-2 (forward) and 6e-2 (gradients) of the
largest value. The card-only tests hold K4 and K5 against the plain walks,
check that they repeat bit for bit, and plant faults in a copy of the kernels'
sources to show that chip_smoke.py's checks catch them."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fastmax_tpu.ops import fastmax as jfm
from fastmax_tpu.ops.fastmax_pallas import (_train_fwd_call, fastmax_pallas,
                                             fastmax_pallas_trainable)
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.ops import fastmax as tfm
from fastmax_tpu_torch.ops import fastmax_kernels as fk
from fastmax_tpu_torch.tools import k5_phases

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
FWD = dict(atol=2e-4, rtol=1e-3)
GRAD = dict(atol=5e-4, rtol=2e-3)


def _inputs(seed, shape, scale=1.0, n_extra=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(3 + n_extra)]


def _torch_vjp(fn, q, k, v, w, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _jax_vjp(fn, q, k, v, w, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(w, dtype))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("p", [1, 2])
def test_trainable_matches_pallas(p, d):
    """fastmax_trainable (the plain walks on the CPU) against
    fastmax_pallas_trainable in interpret mode: output and dq, dk, dv."""
    q, k, v, w = _inputs(p * 100 + d, (1, 2, 256, d))
    got, gg = _torch_vjp(lambda *a: fk.fastmax_trainable(*a, p, 8.0, 128), q, k, v, w)
    ref, rg = _jax_vjp(lambda *a: fastmax_pallas_trainable(*a, p, 8.0, 128, True), q, k, v, w)
    np.testing.assert_allclose(got, ref, **FWD)
    for a, b in zip(gg, rg):
        np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("p", [1, 2])
def test_forward_state_matches_pallas(p):
    """The plain forward's normaliser g and final state (the backward's inputs)
    equal the Pallas forward's, in the reference's packed layout."""
    q, k, v, _ = _inputs(7 + p, (1, 2, 256, 32))
    z = 8.0 * np.sqrt(32)
    _, aux = _train_fwd_call(*(jnp.asarray(a) for a in (q, k, v)), z, p, 128, True)
    _, g, state = fk.fastmax_fwd_plain(*(torch.from_numpy(a).reshape(2, 256, 32)
                                         for a in (q, k, v)), p, z, 128)
    for got, ref in zip((g,) + state, aux):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("p", [1, 2])
def test_forward_only_matches_fastmax_pallas(p):
    q, k, v, _ = _inputs(20 + p, (2, 2, 256, 32))
    got = fk.fastmax_forward(*(torch.from_numpy(a) for a in (q, k, v)), p, 8.0, 128)
    ref = fastmax_pallas(*(jnp.asarray(a) for a in (q, k, v)), p=p, chunk=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


def test_sixteen_chunk_walk_does_not_drift():
    """N = 2048 in 16 chunks: the rewind by subtraction reproduces every
    intermediate state, checked through the gradients."""
    q, k, v, w = _inputs(30, (1, 1, 2048, 16), scale=0.5)
    _, gg = _torch_vjp(lambda *a: fk.fastmax_trainable(*a, 2, 8.0, 128), q, k, v, w)
    _, rg = _jax_vjp(lambda *a: fastmax_pallas_trainable(*a, 2, 8.0, 128, True), q, k, v, w)
    for a, b in zip(gg, rg):
        assert np.abs(a - b).max() / np.abs(b).max() < 5e-3


def test_heads_do_not_leak():
    q, k, v, _ = _inputs(40, (1, 3, 128, 16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    full = fk.fastmax_forward(tq, tk, tv, 1, 8.0, 64)
    solo = fk.fastmax_forward(tq[:, 1:2], tk[:, 1:2], tv[:, 1:2], 1, 8.0, 64)
    np.testing.assert_allclose(full[:, 1:2].numpy(), solo.numpy(), atol=1e-6)
    ref = fastmax_pallas(*(jnp.asarray(a) for a in (q, k, v)), p=1, chunk=64, interpret=True)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **FWD)


def test_ragged_length_pads_the_tail(monkeypatch):
    """fastmax() at N = 200 pads to 256 at the tail: output and dq equal the
    JAX package's Pallas route (interpret) and the O(N^2) reference."""
    monkeypatch.setattr(jfm, "FASTMAX_IMPL", "pallas")
    q, k, v, w = _inputs(50, (1, 2, 200, 32))
    got, gg = _torch_vjp(lambda *a: tfm.fastmax(*a, mask=True, p=2), q, k, v, w)
    ref, rg = _jax_vjp(lambda *a: jfm.fastmax(*a, mask=True, p=2), q, k, v, w)
    np.testing.assert_allclose(got, ref, **FWD)
    for a, b in zip(gg, rg):
        np.testing.assert_allclose(a, b, **GRAD)
    poly = jfm.polynomial_attention_reference(*(jnp.asarray(a) for a in (q, k, v)), p=2)
    np.testing.assert_allclose(got, np.asarray(poly), **FWD)


def test_bfloat16_rounds_the_pair_operands_where_the_reference_does():
    """bf16 inputs at D = 64 against the JAX kernel with bf16 inputs (its
    pair operands then bf16 too), relative to the largest value."""
    q, k, v, w = _inputs(60, (1, 2, 256, 64), scale=0.5)
    got, gg = _torch_vjp(lambda *a: fk.fastmax_trainable(*a, 2, 8.0, 128), q, k, v, w,
                         torch.bfloat16)
    ref, rg = _jax_vjp(lambda *a: fastmax_pallas_trainable(*a, 2, 8.0, 128, True), q, k, v, w,
                       jnp.bfloat16)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 4e-2
    for a, b in zip(gg, rg):
        assert np.abs(a - b).max() / np.abs(b).max() < 6e-2


@pytest.mark.parametrize("p", [1, 2])
def test_unmasked_and_reference_match_jax(p):
    q, k, v, _ = _inputs(70 + p, (1, 2, 64, 16))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfm.fastmax(tq, tk, tv, mask=False, p=p)
    ref = jfm.fastmax(jq, jk, jv, mask=False, p=p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    got = tfm.polynomial_attention_reference(tq, tk, tv, p=p, mask=True)
    ref = jfm.polynomial_attention_reference(jq, jk, jv, p=p, mask=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    assert tfm._auto_chunk(128, 2048) == jfm._auto_chunk(128, 2048) == 256


def test_where_this_slice_stops():
    """Masked fastmax at d = 128 computes (the reversible scan; its values are
    held in tests/test_torch_linear_attention.py); the cached forward and the
    engine with a linear arm compute (their values are held in
    tests/test_torch_linear_cache.py and tests/test_torch_linear_serving.py);
    p = 3 still raises."""
    x = torch.randn((1, 1, 128, 128), generator=torch.Generator().manual_seed(0))
    o = tfm.fastmax(x, x, x, mask=True, p=2)
    assert o.shape == x.shape and bool(torch.isfinite(o).all())
    with pytest.raises(ValueError):
        tfm.fastmax(x[..., :64], x[..., :64], x[..., :64], p=3)
    cfg = Config(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=1, n_head=2,
                 n_embd=64, n_query_groups=1, intermediate_size=128, _norm_class="RMSNorm",
                 _mlp_class="LLaMAMLP", bias=False, attn_alg="linearmax")
    params = gpt.init_params(cfg, seed=0, device="cpu")
    idx = torch.arange(1, 9)[None]
    cache = gpt.init_kv_cache(cfg, 1, 64, device="cpu")
    logits, _ = gpt.forward(params, cfg, idx, input_pos=0, kv_cache=cache)
    assert logits.shape == (1, 8, 128) and bool(torch.isfinite(logits).all())
    assert cache["k"][:, :, :, 8:].abs().sum() == 0 and cache["k"][:, :, :, :8].abs().sum() > 0
    out = InferenceEngine(cfg, params, device="cpu").generate(idx[0], 12)
    assert out.shape == (1, 12) and out[0, :8].tolist() == idx[0].tolist()
    with pytest.raises(ValueError, match="chunk"):
        fk.fastmax_forward(x[..., :64], x[..., :64], x[..., :64], 2, 8.0, 96)
    z = torch.zeros((2, 128, 64))
    state = (torch.zeros(2, 64, 64), torch.zeros(2, 1, 64), torch.zeros(2, fk.sym_width(64), 64),
             torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="g: torch.float64"):  # checked before any launch
        fk._bwd_launch(z, z, z, z, z, torch.zeros((2, 128, 1), dtype=torch.float64), state, 2,
                       64.0, 128)


@pytest.mark.parametrize("p,d,chunk,path", [(2, 64, 128, "tc"), (2, 48, 64, "tc"),
                                             (2, 32, 128, "tc"), (2, 16, 128, "tc"),
                                             (2, 40, 128, "fma"), (2, 64, 256, "tc"),
                                             (2, 64, 512, "tc"), (1, 64, 128, "fma")])
def test_bwd_path_takes_the_tensor_cores_where_the_kernel_can(p, d, chunk, path):
    """K5's tensor-core kernel takes p = 2 at D % 16 == 0, whatever the chunk
    (it holds 128 of a chunk's rows at a time); the rest stays on the FMA
    kernel."""
    assert fk.bwd_path(p, d) == path
    assert chunk % fk.KERNEL_ROWS == 0


@pytest.mark.parametrize("p,d,chunk,path", [(2, 64, 128, "tc"), (2, 48, 64, "tc"),
                                             (2, 32, 128, "tc"), (2, 16, 128, "tc"),
                                             (2, 40, 128, "fma"), (2, 64, 256, "tc"),
                                             (2, 64, 512, "tc"), (1, 64, 128, "fma")])
def test_fwd_path_takes_the_tensor_cores_where_the_kernel_can(p, d, chunk, path):
    """K4's tensor-core kernel takes p = 2 at D % 16 == 0, whatever the chunk
    (its pair CTAs hold 128 of a chunk's rows at a time); the rest stays on
    the FMA kernel."""
    assert fk.fwd_path(p, d) == path
    assert chunk % fk.KERNEL_ROWS == 0


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) as cvt.rna does."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16_parts(x):
    """float32 x = hi + mid + lo exactly, each a bfloat16 value (K5's split)."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, (x - hi - mid).to(torch.bfloat16).float()


def _split_mm(a, b):
    """A float32 product as K5's tensor-core kernel takes it: both operands in
    three bfloat16 parts, the six products down to 2^-16 of the whole."""
    ah, am, al = _bf16_parts(a)
    bh, bm, bl = _bf16_parts(b)
    return (al @ bh + ah @ bl + am @ bm) + (am @ bh + ah @ bm + ah @ bh)


def _walk_pair_products(q, k, v, do, o, g, state, z, chunk, mm):
    """A copy of fastmax_bwd_plain at p = 2 in float32, with its five pair
    products (the S3 rewind, dq2, dk2, dv, the dS3 update) taken by mm."""
    bh, n, d = q.shape
    z2 = 2.0 * z * z
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    s_kv, s_k, s_kkv, s_kk = (x.float().clone() for x in state)
    d_sv = torch.zeros((bh, 1, d))
    d_skv = torch.zeros((bh, d, d))
    d_sk = torch.zeros((bh, 1, d))
    pm, pj, w = fk._pairs(d, "cpu")
    s3 = s_kkv[:, :pm.numel()].clone()
    d_s3 = torch.zeros_like(s3)
    d_skk = torch.zeros((bh, d, d))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for c0 in range(n - chunk, -1, -chunk):
        sl = slice(c0, c0 + chunk)
        qi, ki, vi, doi, oi, gi = q[:, sl], k[:, sl], v[:, sl], do[:, sl], o[:, sl], g[:, sl]
        s_kv = s_kv - ki.transpose(1, 2) @ vi
        s_k = s_k - ki.sum(1, keepdim=True)
        s_kk = s_kk - ki.transpose(1, 2) @ ki
        df = doi / gi
        dgr = -(doi * oi).sum(-1, keepdim=True) / gi
        s = qi @ ki.transpose(1, 2) / z
        fs = 1.0 + s + 0.5 * s * s
        fsp = torch.ones_like(s) + s
        zero = torch.zeros_like(s)
        fs, fsp = torch.where(causal, fs, zero), torch.where(causal, fsp, zero)
        ds = (df @ vi.transpose(1, 2) + dgr) * fsp
        gq = ds @ ki / z
        gk = ds.transpose(1, 2) @ qi / z
        gv = fs.transpose(1, 2) @ df
        gq = gq + df @ s_kv.transpose(1, 2) / z
        gq = gq + dgr * s_k / z
        gq = gq + dgr * (qi @ s_kk) / (z * z)
        gv = gv + d_sv
        gk = gk + vi @ d_skv.transpose(1, 2)
        gv = gv + ki @ d_skv
        gk = gk + d_sk
        gk = gk + ki @ d_skk + ki @ d_skk.transpose(1, 2)
        k2 = ki[..., pm] * ki[..., pj]
        s3 = s3 - mm(k2.transpose(1, 2), vi)
        qa, qb = qi[..., pm], qi[..., pj]
        dq2 = mm(df, s3.transpose(1, 2)) * w
        gq = gq + (fk._fold(dq2 * qb, pm, d) + fk._fold(dq2 * qa, pj, d)) / z2
        dk2 = mm(vi, d_s3.transpose(1, 2))
        gk = gk + (fk._fold(dk2 * ki[..., pj], pm, d) + fk._fold(dk2 * ki[..., pm], pj, d))
        gv = gv + mm(k2, d_s3)
        d_s3 = d_s3 + mm((qa * qb * w).transpose(1, 2), df) / z2
        d_sv = d_sv + df.sum(1, keepdim=True)
        d_skv = d_skv + qi.transpose(1, 2) @ df / z
        d_sk = d_sk + (dgr * qi).sum(1, keepdim=True) / z
        d_skk = d_skk + qi.transpose(1, 2) @ (dgr * qi) / z2
        dq[:, sl], dk[:, sl], dv[:, sl] = gq, gk, gv
    return dq, dk, dv


def test_split_holds_the_f32_gate():
    """K5's float32 split on the pair products of the walk at (1, 2, 512, 64),
    p = 2, with phase 8's law (q, k std sqrt(8): s of order 1): the parts add
    up to each operand exactly, and the gradients lie within
    FASTMAX_F32_REL["grad"] of the exact walk (dq 1.1e-5 of its largest value,
    a fifth of the gate at most), where one TF32 product (what a single
    tensor-core pass over float32 would give) puts dq at 1.2e-2, far over it."""
    rng = np.random.default_rng(13)
    std = chip_smoke.FASTMAX_QK_STD[2]
    q, k, v, do = (torch.from_numpy((rng.standard_normal((2, 512, 64)) * s).astype(np.float32))
                   for s in (std, std, 1.0, 1.0))
    hi, mid, lo = _bf16_parts(q)
    assert torch.equal(hi + mid + lo, q)
    z = 8.0 * np.sqrt(64)
    o, g, state = fk.fastmax_fwd_plain(q, k, v, 2, z, 128)
    args = (q, k, v, do, o, g, state, z, 128)
    exact = _walk_pair_products(*args, lambda a, b: a @ b)
    for a, b in zip(exact, fk.fastmax_bwd_plain(q, k, v, do, o, g, state, 2, z, 128)):
        assert torch.equal(a, b)  # the copy is the plain walk
    gate = chip_smoke.FASTMAX_F32_REL["grad"]
    errs = {}
    for name, mm in (("split", _split_mm), ("tf32", lambda a, b: _tf32(a) @ _tf32(b))):
        got = _walk_pair_products(*args, mm)
        errs[name] = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, exact)]
    assert max(errs["split"]) <= gate / 5, errs
    assert errs["tf32"][0] > 10 * gate, errs


def _walk_fwd_pair_products(q, k, v, z, chunk, mm):
    """A copy of fastmax_fwd_plain at p = 2 in float32, with its two pair
    products (f2 = (Q2 w) S3 and the S3 update K2^T v) taken by mm."""
    bh, n, d = q.shape
    z2 = 2.0 * z * z
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    s_v = torch.zeros((bh, 1, d))
    s_kv = torch.zeros((bh, d, d))
    s_k = torch.zeros((bh, 1, d))
    s_kk = torch.zeros((bh, d, d))
    pm, pj, w = fk._pairs(d, "cpu")
    s3 = torch.zeros((bh, pm.numel(), d))
    o = torch.empty_like(q)
    g = torch.empty((bh, n, 1))
    for c0 in range(0, n, chunk):
        qi, ki, vi = (x[:, c0:c0 + chunk] for x in (q, k, v))
        s = qi @ ki.transpose(1, 2) / z
        fs = 1.0 + s
        fs = fs + 0.5 * s * s
        fs = torch.where(causal, fs, torch.zeros_like(fs))
        f = fs @ vi + s_v + qi @ s_kv / z
        gi = fs.sum(-1, keepdim=True) + float(c0) + qi @ s_k.transpose(1, 2) / z
        gi = gi + ((qi @ s_kk) * qi).sum(-1, keepdim=True) / z2
        f = f + mm(qi[..., pm] * qi[..., pj] * w, s3) / z2
        o[:, c0:c0 + chunk] = f / gi
        g[:, c0:c0 + chunk] = gi
        s_v = s_v + vi.sum(1, keepdim=True)
        s_kv = s_kv + ki.transpose(1, 2) @ vi
        s_k = s_k + ki.sum(1, keepdim=True)
        s_kk = s_kk + ki.transpose(1, 2) @ ki
        s3 = s3 + mm((ki[..., pm] * ki[..., pj]).transpose(1, 2), vi)
    return o, g, s3


def test_forward_split_holds_the_f32_gate():
    """K4's float32 split on the pair products of the forward walk at
    (1, 2, 512, 64), p = 2, with phase 8's law (q, k std sqrt(8)): o and the
    final S3 lie within FASTMAX_F32_REL["fwd"] of the exact walk (a fifth of
    the gate at most), where one TF32 product (what a single tensor-core pass
    over float32 would give) puts o outside it."""
    rng = np.random.default_rng(14)
    std = chip_smoke.FASTMAX_QK_STD[2]
    q, k, v = (torch.from_numpy((rng.standard_normal((2, 512, 64)) * s).astype(np.float32))
               for s in (std, std, 1.0))
    z = 8.0 * np.sqrt(64)
    exact = _walk_fwd_pair_products(q, k, v, z, 128, lambda a, b: a @ b)
    o, g, state = fk.fastmax_fwd_plain(q, k, v, 2, z, 128)
    for a, b in zip(exact, (o, g, state[2][:, :exact[2].shape[1]])):
        assert torch.equal(a, b)  # the copy is the plain walk
    gate = chip_smoke.FASTMAX_F32_REL["fwd"]
    errs = {}
    for name, mm in (("split", _split_mm), ("tf32", lambda a, b: _tf32(a) @ _tf32(b))):
        got = _walk_fwd_pair_products(q, k, v, z, 128, mm)
        errs[name] = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, exact)]
    assert max(errs["split"]) <= gate / 5, errs
    assert errs["tf32"][0] > gate, errs


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((2, 4, 512, 64), 128), ((1, 3, 256, 48), 64),
                                         ((1, 2, 384, 32), 128), ((1, 3, 384, 48), 192),
                                         ((1, 2, 1024, 64), 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2])
def test_kernels_match_plain_on_the_card(p, dtype, shape, chunk):
    """K4 (both modes) and K5 against the plain walks: head sizes whose pair
    count is not a whole number of tiles (48: 1176 pairs, split four ways),
    64-row chunks, chunk counts that are not powers of two, chunks that K5's
    pair CTAs take in parts (192 rows: 128 and 64; 512: four of 128). q and k as in
    chip_smoke.py: s = q.k / z of order 1 at p = 2, so the degree-2 terms
    weigh as much as the others. Each output within chip_smoke.py's
    tolerances of its largest value (f32: 1e-5 forward, 1e-4 gradients; bf16:
    the reference's 4e-2 and 6e-2)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(p)
    std = chip_smoke.FASTMAX_QK_STD[p]
    q, k, v, w = (torch.randn(shape, generator=gen, device="cuda") * s
                  for s in (std, std, 1.0, 1.0))
    tol = chip_smoke.FASTMAX_F32_REL if dtype == torch.float32 else chip_smoke.FASTMAX_BF16_REL
    outs = {}
    for plain in (False, True):
        ts = [x.to(dtype).requires_grad_(True) for x in (q, k, v)]
        before = build.launch_counts()
        o = fk.fastmax_trainable(*ts, p, 8.0, chunk, plain=plain)
        (o.float() * w).sum().backward()
        only = fk.fastmax_forward(*(t.detach() for t in ts), p, 8.0, chunk, plain=plain)
        torch.cuda.synchronize()
        after = build.launch_counts()
        assert after["fastmax_fwd"] - before["fastmax_fwd"] == (0 if plain else 2)
        assert after["fastmax_bwd"] - before["fastmax_bwd"] == (0 if plain else 1)
        outs[plain] = [o, only] + [t.grad for t in ts]
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err <= tol["fwd" if i < 2 else "grad"], (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((2, 4, 512, 64), 128), ((1, 3, 256, 48), 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fma_kernel_matches_plain_on_the_card(dtype, shape, chunk):
    """K5's FMA kernel, taken by passing the path, where bwd_path picks the
    tensor cores: dq, dk, dv against the plain walk on the forward's state,
    at chip_smoke.py's tolerances."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, h, n, d = shape
    q, k, v, do = chip_smoke.fastmax_qkv(torch, gen, (b * h, n, d), 2, dtype)
    z = 8.0 * np.sqrt(d)
    o, g, state = fk.fastmax_fwd_plain(q, k, v, 2, z, chunk)
    assert fk.bwd_path(2, d) == "tc"
    got = fk._bwd_launch(q, k, v, do, o, g, state, 2, z, chunk, path="fma")
    ref = fk.fastmax_bwd_plain(q, k, v, do, o, g, state, 2, z, chunk)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        chip_smoke.fastmax_close(torch, f"K5 (fma) {name}", a, r, "grad", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((2, 4, 512, 64), 128), ((1, 3, 256, 48), 64),
                                         ((1, 2, 384, 32), 128), ((1, 3, 384, 48), 192),
                                         ((1, 4, 1024, 64), 256), ((1, 2, 1024, 64), 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["tc", "fma"])
def test_forward_kernels_match_plain_on_the_card(path, dtype, shape, chunk):
    """K4 at p = 2 on the kernel of ``path``, passed explicitly (the FMA
    kernel where fwd_path picks the tensor cores): o, g and the final state
    against the plain walk, in both modes (B11's forward alone too), at
    chip_smoke.py's forward tolerances; chunks of 192, 256 and 512 rows, which
    the tc kernel's pair CTAs take in parts. Two calls give the same bits."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, h, n, d = shape
    q, k, v, _ = chip_smoke.fastmax_qkv(torch, gen, (b * h, n, d), 2, dtype)
    z = 8.0 * np.sqrt(d)
    assert fk.fwd_path(2, d) == "tc"
    o, g, state = fk._fwd_launch(q, k, v, 2, z, chunk, train=True, path=path)
    ref_o, ref_g, ref_state = fk.fastmax_fwd_plain(q, k, v, 2, z, chunk)
    only = fk._fwd_launch(q, k, v, 2, z, chunk, train=False, path=path)
    for name, a, r in zip(("o", "o (forward only)", "g", "s_kv", "s_k", "s_kkv", "s_kk"),
                          (o, only, g) + tuple(state), (ref_o, ref_o, ref_g) + tuple(ref_state)):
        chip_smoke.fastmax_close(torch, f"K4 ({path}) {name}", a, r, "fwd", dtype)
    again = fk._fwd_launch(q, k, v, 2, z, chunk, train=True, path=path)
    for a, b_ in zip((o, g) + tuple(state), (again[0], again[1]) + tuple(again[2])):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_tensor_core_forward_refuses_what_it_does_not_take():
    """The C entry refuses a tc launch of K4 outside the kernel's conditions
    (p = 1; a head size of 40, not a multiple of 16) rather than running it."""
    _needs_card()
    for p, d in ((1, 64), (2, 40)):
        x = torch.zeros((2, 256, d), device="cuda")
        for train in (True, False):
            with pytest.raises(RuntimeError, match="launch failed"):
                fk._fwd_launch(x, x, x, p, 64.0, 128, train=train, path="tc")


@pytest.mark.cuda
def test_tensor_core_kernel_refuses_what_it_does_not_take():
    """The C entry refuses a tc launch outside the kernel's conditions (p = 1;
    a head size of 40, not a multiple of 16) rather than running it."""
    _needs_card()
    for p, d in ((1, 64), (2, 40)):
        x = torch.zeros((2, 256, d), device="cuda")
        o, g, state = fk.fastmax_fwd_plain(x, x, x, p, 64.0, 128)
        with pytest.raises(RuntimeError, match="launch failed"):
            fk._bwd_launch(x, x, x, x, o, g, state, p, 64.0, 128, path="tc")


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    chip_smoke.fastmax_repeats(torch, gen, (2, 4, 512, 64), 128)


# faults planted in a copy of csrc/: (kernel, file, the code as written, as planted).
# The tensor-core kernels, which the check's shape (p = 2, D = 64, chunk 128) takes: a
# term dropped (a product over no pairs, a fold left out, a tile left as it came, a sum
# left out of g), a state update taken before the reads it must follow (right for the
# first chunk walked only in K5), the float32 split's correction products dropped (each
# product then bf16(a) bf16(b), about 2^-8 of its size), and, at a chunk of 256 rows
# that the pair CTAs hold in two parts, the S3 update (K4) or rewind (K5) by all parts
# but the last left out; then the same pair terms dropped from the FMA kernels.
FAULTS = {
    "K4 f2 = (Q2 w) S3": ("fastmax_fwd", "fastmax_fwd.cu", "PairSmem::kTilePlane, 0, kPT);",
                          "PairSmem::kTilePlane, 0, 0);"),
    "K4 S3 update": ("fastmax_fwd", "fastmax_fwd.cu",
                     "fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 1.f);",
                     "fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 0.f);"),
    "K4 S3 updated before f2 reads it": (
        "fastmax_fwd", "fastmax_fwd.cu",
        "        if (first) s3_read<T>(sb, f2, p0, rows);\n"
        "        if (second) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 1.f);\n",
        "        if (second) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 1.f);\n"
        "        if (first) s3_read<T>(sb, f2, p0, rows);\n"),
    "K4 sub-chunks: the update by all but the last dropped": (
        "fastmax_fwd", "fastmax_fwd.cu",
        "        if (second) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 1.f);\n",
        "        if (first && second) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 1.f);\n"),
    "K4 g without rowsum((q s_kk) q)": ("fastmax_fwd", "fastmax_fwd.cu",
                                         "        gv += (a[2 * kR] + b[2 * kR]) / z2;\n", ""),
    "K4 f32 split: correction products dropped": (
        "fastmax_fwd", "fastmax_tc.cuh",
        "    mma16816(part, a[2], b[0][2 * h], b[0][2 * h + 1]);\n"
        "    mma16816(part, a[0], b[2][2 * h], b[2][2 * h + 1]);\n"
        "    mma16816(part, a[1], b[1][2 * h], b[1][2 * h + 1]);\n"
        "    mma16816(part, a[1], b[0][2 * h], b[0][2 * h + 1]);\n"
        "    mma16816(part, a[0], b[1][2 * h], b[1][2 * h + 1]);\n", ""),
    "K5 dq fold over S3": ("fastmax_bwd", "fastmax_bwd.cu",
                           "  fold<T>(oq, t, PairSmem::qs() + r0 * kLDF, pmj);\n", ""),
    "K5 dk fold over dS3": ("fastmax_bwd", "fastmax_bwd.cu",
                            "  fold<T>(ok, t, PairSmem::ks() + r0 * kLDF, pmj);\n", ""),
    "K5 dv += K2 dS3": ("fastmax_bwd", "fastmax_bwd.cu",
                        "PairSmem::kTilePlane, 0, kPT);", "PairSmem::kTilePlane, 0, 0);"),
    "K5 S3 rewind": ("fastmax_bwd", "fastmax_bwd.cu",
                     "fmtc::s3_update<T>(sb, s3, p0, np, d, rows, -1.f);",
                     "fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 0.f);"),
    "K5 dS3 update": ("fastmax_bwd", "fastmax_bwd.cu",
                      "const float updated = sb[i] + inv_z2 * acc[nt][e];",
                      "const float updated = sb[i];"),
    "K5 dS3 updated before dv and dk read it": (
        "fastmax_bwd", "fastmax_bwd.cu",
        "          if (first) ds3_reads<T>(sb, sums, gv, p0, d, rows);\n"
        "          if (second) ds3_update<T>(sb, ds3, p0, np, d, rows, inv_z2);\n",
        "          if (second) ds3_update<T>(sb, ds3, p0, np, d, rows, inv_z2);\n"
        "          if (first) ds3_reads<T>(sb, sums, gv, p0, d, rows);\n"),
    "K5 sub-chunks: the rewind by all but the last dropped": (
        "fastmax_bwd", "fastmax_bwd.cu",
        "          if (first) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, -1.f);\n",
        "          if (first && second) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, -1.f);\n"),
    "K5 f32 split: correction products dropped": (
        "fastmax_bwd", "fastmax_tc.cuh",
        "    mma16816(part, a[2], b[0][2 * h], b[0][2 * h + 1]);\n"
        "    mma16816(part, a[0], b[2][2 * h], b[2][2 * h + 1]);\n"
        "    mma16816(part, a[1], b[1][2 * h], b[1][2 * h + 1]);\n"
        "    mma16816(part, a[1], b[0][2 * h], b[0][2 * h + 1]);\n"
        "    mma16816(part, a[0], b[1][2 * h], b[1][2 * h + 1]);\n", ""),
    # the FMA kernels' pair terms (p = 1, other head sizes), planted with the check's
    # calls sent to them (FMA_FAULTS)
    "K4 (fma) f2 = (Q2 w) S3": ("fastmax_fwd", "fastmax_fwd.cu",
                                "pair_out<T>(f2, qs, s3, d, lo, hi,",
                                "pair_out<T>(f2, qs, s3, d, lo, lo,"),
    "K5 (fma) dq fold over S3": ("fastmax_bwd", "fastmax_bwd.cu",
                                 "pair_fold<T>(acc_t, qs, df, s3, d, lo, hi,",
                                 "pair_fold<T>(acc_t, qs, df, s3, d, lo, lo,"),
    "K5 (fma) dk fold over dS3": ("fastmax_bwd", "fastmax_bwd.cu",
                                  "pair_fold<T>(acc_t, ks, vs, ds3, d, lo, hi,",
                                  "pair_fold<T>(acc_t, ks, vs, ds3, d, lo, lo,"),
    "K5 (fma) dv += K2 dS3": ("fastmax_bwd", "fastmax_bwd.cu",
                              "pair_out<T>(gv, ks, ds3, d, lo, hi,",
                              "pair_out<T>(gv, ks, ds3, d, lo, lo,"),
    "K5 (fma) S3 rewind": ("fastmax_bwd", "fastmax_bwd.cu",
                           "pair_update<T>(s3, ks, vs, d, lo, hi, false, -1.f,",
                           "pair_update<T>(s3, ks, vs, d, lo, hi, false, 0.f,"),
    "K5 (fma) dS3 update": ("fastmax_bwd", "fastmax_bwd.cu",
                            "pair_update<T>(ds3, qs, df, d, lo, hi,",
                            "pair_update<T>(ds3, qs, df, d, lo, lo,"),
}
FMA_FAULTS = {f for f in FAULTS if "(fma)" in f}
# the check's (B, H, N, D) and chunk: a chunk of 128 rows, or 256 for a fault of the parts
FAULT_CASES = {f: ((2, 4, 1024, 64), 256) if "sub-chunks" in f else ((2, 4, 512, 64), 128)
               for f in FAULTS}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_kernel_source_holds_the_planted_lines(fault):
    """Each fault's code occurs once in its source, so the card test plants
    exactly the fault it names."""
    _, source, written, _ = FAULTS[fault]
    assert (build.CSRC_DIR / source).read_text().count(written) == 1


@pytest.mark.parametrize("i", range(len(k5_phases.PROBES)))
def test_phase_probe_anchor_occurs_once(i):
    """tools/k5_phases.py puts each clock probe before or after a line of K5's
    source: each such line occurs there once."""
    anchor = k5_phases.PROBES[i][0]
    assert (build.CSRC_DIR / "fastmax_bwd.cu").read_text().count(anchor) == 1


def test_phase_probes_instrument_the_source():
    """Every anchor of tools/k5_phases.py (the probes and the counters' start
    and end) is found once, and each probe lands in the copy."""
    text = k5_phases.instrumented(build.CSRC_DIR)
    ticks = sum((b is not None) + (a is not None) for _, b, a in k5_phases.PROBES)
    assert text.count("fm_tick(") == 1 + ticks  # the definition and the calls


def _planted(tmp_path, fault):
    name, source, written, planted = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    text = (src / source).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {source} once"
    (src / source).write_text(text.replace(written, planted))
    real = build.KERNELS[name]
    return name, build.Kernel(name, str(src / real.source.name), real.replaces, real.entry,
                              real.argtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_dropped_degree2_term(fault, tmp_path, monkeypatch):
    """chip_smoke.py's kernel check fails for a kernel built with one of its
    degree-2 terms (or its S3 update or rewind) left out, with a state update
    taken too early, with g short of a term, or with its float32 split cut to
    one product; the FMA kernels too, with the check's calls sent to them; for
    K4's f2 and K5's dq fold, so does its one-step check of the model's loss
    and gradients."""
    _needs_card()
    from fastmax_tpu_torch.models.config import Config

    name, faulty = _planted(tmp_path, fault)
    if fault in FMA_FAULTS:
        monkeypatch.setattr(fk, "fwd_path", lambda p, d: "fma")
        monkeypatch.setattr(fk, "bwd_path", lambda p, d: "fma")
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape, chunk = FAULT_CASES[fault]
    chip_smoke.fastmax_case(torch, gen, shape, 2, chunk, torch.float32)  # sound
    monkeypatch.setitem(build.KERNELS, name, faulty)
    with pytest.raises(AssertionError, match=fault[:2]) as caught:
        chip_smoke.fastmax_case(torch, gen, shape, 2, chunk, torch.float32)
    print(f"{fault}: {caught.value}")
    if fault in ("K4 f2 = (Q2 w) S3", "K5 dq fold over S3"):
        cfg = Config.from_name("easy-transformer-fastmax", n_layer=2)
        batch = torch.randint(0, 205, (2, 513), generator=gen, device="cuda")
        with pytest.raises(AssertionError, match="kernels vs plain") as caught:
            chip_smoke.step_kernels_vs_plain(torch, cfg, batch)
        print(f"{fault}, one step: {caught.value}")
