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
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import fastmax as tfm
from fastmax_tpu_torch.ops import fastmax_kernels as fk

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
    x = torch.zeros((1, 1, 128, 128))
    with pytest.raises(NotImplementedError, match="linear-cache"):
        tfm.fastmax(x, x, x, mask=True, p=2)
    with pytest.raises(ValueError):
        tfm.fastmax(x[..., :64], x[..., :64], x[..., :64], p=3)
    with pytest.raises(ValueError, match="chunk"):
        fk.fastmax_forward(x[..., :64], x[..., :64], x[..., :64], 2, 8.0, 96)
    z = torch.zeros((2, 128, 64))
    state = (torch.zeros(2, 64, 64), torch.zeros(2, 1, 64), torch.zeros(2, fk.sym_width(64), 64),
             torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="g: torch.float64"):  # checked before any launch
        fk._bwd_launch(z, z, z, z, z, torch.zeros((2, 128, 1), dtype=torch.float64), state, 2,
                       64.0, 128)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((2, 4, 512, 64), 128), ((1, 3, 256, 48), 64),
                                         ((1, 2, 384, 32), 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2])
def test_kernels_match_plain_on_the_card(p, dtype, shape, chunk):
    """K4 (both modes) and K5 against the plain walks: head sizes whose pair
    count is not a whole number of tiles (48: 1176 pairs, split four ways),
    64-row chunks, chunk counts that are not powers of two. q and k as in
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
def test_kernels_repeat_bit_for_bit():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    chip_smoke.fastmax_repeats(torch, gen, (2, 4, 512, 64), 128)


# faults planted in a copy of csrc/: (kernel, file, the call as written, as planted).
# An empty pair range [lo, lo) drops a degree-2 term; alpha 0 drops the rewind.
FAULTS = {
    "K4 f2 = (Q2 w) S3": ("fastmax_fwd", "fastmax_fwd.cu",
                          "pair_out<T>(f2, qs, s3, d, lo, hi,", "pair_out<T>(f2, qs, s3, d, lo, lo,"),
    "K5 dq fold over S3": ("fastmax_bwd", "fastmax_bwd.cu",
                           "pair_fold<T>(acc_t, qs, df, s3, d, lo, hi,",
                           "pair_fold<T>(acc_t, qs, df, s3, d, lo, lo,"),
    "K5 dk fold over dS3": ("fastmax_bwd", "fastmax_bwd.cu",
                            "pair_fold<T>(acc_t, ks, vs, ds3, d, lo, hi,",
                            "pair_fold<T>(acc_t, ks, vs, ds3, d, lo, lo,"),
    "K5 dv += K2 dS3": ("fastmax_bwd", "fastmax_bwd.cu",
                        "pair_out<T>(gv, ks, ds3, d, lo, hi,", "pair_out<T>(gv, ks, ds3, d, lo, lo,"),
    "K5 S3 rewind": ("fastmax_bwd", "fastmax_bwd.cu",
                     "pair_update<T>(s3, ks, vs, d, lo, hi, false, -1.f,",
                     "pair_update<T>(s3, ks, vs, d, lo, hi, false, 0.f,"),
    "K5 dS3 update": ("fastmax_bwd", "fastmax_bwd.cu",
                      "pair_update<T>(ds3, qs, df, d, lo, hi,",
                      "pair_update<T>(ds3, qs, df, d, lo, lo,"),
}


def _planted(tmp_path, fault):
    name, source, written, planted = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    text = (src / source).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {source} once"
    (src / source).write_text(text.replace(written, planted))
    real = build.KERNELS[name]
    return name, build.Kernel(name, str(src / source), real.replaces, real.entry, real.argtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_dropped_degree2_term(fault, tmp_path, monkeypatch):
    """chip_smoke.py's kernel check fails for a kernel built with one of its
    degree-2 terms (or K5's rewind of S3) left out; for K4's f2 and K5's dq
    fold, so does its one-step check of the model's loss and gradients."""
    _needs_card()
    from fastmax_tpu_torch.models.config import Config

    name, faulty = _planted(tmp_path, fault)
    gen = torch.Generator(device="cuda").manual_seed(5)
    chip_smoke.fastmax_case(torch, gen, (2, 4, 512, 64), 2, 128, torch.float32)  # sound
    monkeypatch.setitem(build.KERNELS, name, faulty)
    with pytest.raises(AssertionError, match=fault[:2]) as caught:
        chip_smoke.fastmax_case(torch, gen, (2, 4, 512, 64), 2, 128, torch.float32)
    print(f"{fault}: {caught.value}")
    if fault in ("K4 f2 = (Q2 w) S3", "K5 dq fold over S3"):
        cfg = Config.from_name("easy-transformer-fastmax", n_layer=2)
        batch = torch.randint(0, 205, (2, 513), generator=gen, device="cuda")
        with pytest.raises(AssertionError, match="kernels vs plain") as caught:
            chip_smoke.step_kernels_vs_plain(torch, cfg, batch)
        print(f"{fault}, one step: {caught.value}")
