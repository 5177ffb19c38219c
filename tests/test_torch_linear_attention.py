"""The port's linear attention at every head size (fastmax_tpu_torch/ops/
fastmax.py: the reversible chunked scan at d > 64, linearmax, performer; and
their arms of ops/attention.attention) against the JAX package on the CPU, on
the same numpy inputs.

Tolerances are the reference's own (tests/test_fastmax.py): against the
quadratic formula atol 2e-2, rtol 1e-2 (outputs) and 5e-2 (gradients); the
port against the JAX scan on the same inputs, forward atol 2e-4, rtol 1e-3,
gradients atol 1e-4, rtol 1e-3 (the custom-VJP gate of :164); head groups
1e-5 (:208); bfloat16 4e-2 (forward) and 6e-2 (gradients) of the largest
value (tests/test_fastmax_pallas.py).

Run as a script, it prints the f32 gradient error from float64 of the JAX
scan and of the port at the shapes the card checks use (the yardstick is the
port's scan in float64):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_linear_attention.py
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.ops import attention as jattn
from fastmax_tpu.ops import fastmax as jfm
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.ops import attention as tattn
from fastmax_tpu_torch.ops import fastmax as tfm
from fastmax_tpu_torch.training.step import make_loss_fn, tree_leaves

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
QUAD = dict(atol=2e-2, rtol=1e-2)
QUAD_GRAD = dict(atol=5e-2, rtol=5e-2)
FWD = dict(atol=2e-4, rtol=1e-3)
GRAD = dict(atol=1e-4, rtol=1e-3)
SAME = dict(atol=1e-5, rtol=1e-5)
BF16_FWD, BF16_GRAD = 4e-2, 6e-2


def _inputs(seed, shape, n=4, qk_std=1.0):
    rng = np.random.default_rng(seed)
    q, k = ((rng.standard_normal(shape) * qk_std).astype(np.float32) for _ in range(2))
    return [q, k] + [rng.standard_normal(shape).astype(np.float32) for _ in range(n - 2)]


def _torch_vjp(fn, args, w, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in args]
    out = fn(*ts)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


def _jax_vjp(fn, args, w, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in args))
    grads = vjp(jnp.asarray(w, out.dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _close(got, ref, gots, refs, fwd=FWD, grad=GRAD):
    np.testing.assert_allclose(got, ref, **fwd)
    for name, a, b in zip("qkv", gots, refs):
        np.testing.assert_allclose(a, b, **grad, err_msg=f"d{name}")


# ------------------------------------------------------------------ fastmax at d > 64


@pytest.mark.parametrize("p", [1, 2])
def test_fastmax_d128_matches_jax(p):
    """Masked fastmax at d = 128 (N = 200 in chunks of 64, a ragged tail):
    output and q, k, v gradients against the JAX package's scan, and the
    output against the quadratic formula."""
    q, k, v, w = _inputs(p, (1, 2, 200, 128))
    got, gg = _torch_vjp(lambda *a: tfm.fastmax(*a, mask=True, p=p, chunk=64), (q, k, v), w)
    ref, rg = _jax_vjp(lambda *a: jfm.fastmax(*a, mask=True, p=p, chunk=64), (q, k, v), w)
    _close(got, ref, gg, rg)
    quad = jfm.polynomial_attention_reference(*(jnp.asarray(a) for a in (q, k, v)), p=p)
    np.testing.assert_allclose(got, np.asarray(quad), **QUAD)


@pytest.mark.parametrize("p", [1, 2])
def test_fastmax_d128_gradients_match_the_quadratic_formula(p):
    """The gradients of the scan against autodiff of the O(N^2) formula
    (tests/test_fastmax.py:145), at d = 128."""
    q, k, v, w = (a[:, :1, :48] for a in _inputs(10 + p, (1, 2, 48, 128)))
    _, gg = _torch_vjp(lambda *a: tfm.fastmax(*a, mask=True, p=p, chunk=16), (q, k, v), w)
    _, rg = _jax_vjp(lambda *a: jfm.polynomial_attention_reference(*a, p=p), (q, k, v), w)
    for a, b in zip(gg, rg):
        np.testing.assert_allclose(a, b, **QUAD_GRAD)


def test_fastmax_d128_ragged_tails():
    """N = 137 in chunks of 64 (tests/test_fastmax.py:53) forward, and N = 100
    in chunks of 32 (:189) gradients: the padding and the cnt correction of
    the forward and of the reversible backward."""
    q, k, v = _inputs(20, (1, 2, 137, 128), 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfm.fastmax(tq, tk, tv, mask=True, p=2, chunk=64).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jfm.fastmax(jq, jk, jv, mask=True, p=2, chunk=64)),
                               **FWD)
    np.testing.assert_allclose(got, np.asarray(jfm.polynomial_attention_reference(jq, jk, jv, p=2)),
                               **QUAD)
    q, k, v, w = _inputs(21, (1, 1, 100, 128))
    got, gg = _torch_vjp(lambda *a: tfm.fastmax(*a, mask=True, p=2, chunk=32), (q, k, v), w)
    ref, rg = _jax_vjp(lambda *a: jfm.fastmax(*a, mask=True, p=2, chunk=32), (q, k, v), w)
    _close(got, ref, gg, rg)
    _, qg = _jax_vjp(lambda *a: jfm.polynomial_attention_reference(*a, p=2), (q, k, v), w)
    for a, b in zip(gg, qg):
        np.testing.assert_allclose(a, b, **QUAD_GRAD)


@pytest.mark.parametrize("p", [1, 2])
def test_fastmax_d128_chunk_invariance(p):
    q, k, v = (torch.from_numpy(a) for a in _inputs(30 + p, (1, 2, 200, 128), 3))
    a = tfm.fastmax(q, k, v, mask=True, p=p, chunk=32)
    b = tfm.fastmax(q, k, v, mask=True, p=p, chunk=200)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **QUAD)


@pytest.mark.parametrize("p", [1, 2])
def test_head_groups_match_all_heads_at_once(p):
    """head_group 2 runs the heads in two groups, one after the other: the same
    outputs and gradients as all heads at once (tests/test_fastmax.py:208)."""
    q, k, v, _ = _inputs(40 + p, (1, 2, 128, 128))
    w = np.cos(np.arange(q.size, dtype=np.float32)).reshape(q.shape)
    runs = [_torch_vjp(lambda *a, g=g: tfm.fastmax(*a, mask=True, p=p, chunk=64, head_group=g),
                       (q, k, v), w) for g in (1, 2)]
    _close(runs[0][0], runs[1][0], runs[0][1], runs[1][1], SAME, SAME)
    with pytest.raises(ValueError, match="divide"):
        tfm.fastmax(*(torch.from_numpy(a) for a in (q, k, v)), mask=True, p=p, head_group=3)


@pytest.mark.parametrize("b,h,d,p", [(2, 3, 16, 1), (2, 3, 16, 2), (16, 32, 64, 2),
                                     (16, 12, 64, 2), (2, 32, 128, 2), (2, 32, 128, 1),
                                     (1, 4, 128, 2), (4, 8, 128, 2), (1, 7, 256, 2)])
def test_auto_head_groups_matches_jax(b, h, d, p):
    """The grid of tests/test_fastmax.py:230 and the 7B finetune shape: 8 groups
    of 4 heads for a 512 MiB p = 2 state at the 64 MiB default."""
    got = tfm._auto_head_groups(b, h, d, p)
    assert got == jfm._auto_head_groups(b, h, d, p)
    assert h % got == 0
    if (b, h, d, p) == (2, 32, 128, 2):
        assert got == 8


@pytest.mark.parametrize("shape,p", [((1, 2, 512, 16), 1), ((1, 2, 512, 16), 2),
                                     ((1, 2, 200, 128), 2)])
def test_function_matches_autograd_through_the_scan(shape, p):
    """The reversible backward against autograd through ``_masked_chunked``,
    which keeps every chunk's state (tests/test_fastmax.py:164), and the
    final state against the JAX scan's."""
    q, k, v, w = _inputs(50 + p, shape)
    z = 8.0 * math.sqrt(shape[-1])
    got, gg = _torch_vjp(lambda *a: tfm._masked_chunked_vjp(*a, z, p, 64), (q, k, v), w)
    ref, rg = _torch_vjp(lambda *a: tfm._masked_chunked(*a, z, p, 64), (q, k, v), w)
    _close(got, ref, gg, rg)
    _, state = tfm._masked_chunked(*(torch.from_numpy(a) for a in (q, k, v)), z, p, 64,
                                   return_state=True)
    _, jstate = jfm._masked_chunked(*(jnp.asarray(a) for a in (q, k, v)), z, p, 64,
                                    return_state=True)
    assert sorted(state) == sorted(tfm.STATE_NAMES[:6 if p == 2 else 4])
    for name, x in state.items():
        ref = np.asarray(jstate[name])
        np.testing.assert_allclose(x.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_function_saves_one_state_not_one_a_chunk():
    """The Function keeps q, k, v and the final state for the backward, O(d^3)
    a head: at 8 chunks a state a chunk would be 8 times that."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(60, (1, 2, 512, 32), 3))
    z = 8.0 * math.sqrt(32)
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        o = tfm._masked_chunked_vjp(q, k, v, z, 2, 64)
    _, state = tfm._masked_chunked(q.detach(), k.detach(), v.detach(), z, 2, 64,
                                   return_state=True)
    allowed = 3 * q.numel() + sum(x.numel() for x in state.values())
    assert 0 < sum(saved) <= allowed, (sum(saved), allowed)
    o.sum().backward()
    assert all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))


def test_fastmax_bf16_keeps_its_type_and_matches_jax():
    """bf16 q, k, v: the scan runs in float32 and the output is cast back, in
    both packages."""
    q, k, v, w = _inputs(70, (1, 2, 200, 128))
    got, gg = _torch_vjp(lambda *a: tfm.fastmax(*a, mask=True, p=2, chunk=64), (q, k, v), w,
                         torch.bfloat16)
    ref, rg = _jax_vjp(lambda *a: jfm.fastmax(*a, mask=True, p=2, chunk=64), (q, k, v), w,
                       jnp.bfloat16)
    out = tfm.fastmax(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), mask=True, p=2)
    assert out.dtype == torch.bfloat16
    assert np.abs(got - ref).max() <= BF16_FWD * np.abs(ref).max()
    for a, b in zip(gg, rg):
        assert np.abs(a - b).max() <= BF16_GRAD * np.abs(b).max()


def scan_grad_errors(shape, chunk, seed=0):
    """max|f32 - f64| / max|f64| of the output and of dq, dk, dv, for the JAX
    package's reversible scan and for the port's, on q, k drawn at std
    sqrt(8) (s = q.k / z then has a standard deviation of about 1, as in
    chip_smoke.py) and v, the cotangent at std 1; the yardstick is the port's
    scan in float64."""
    q, k, v, w = (a.astype(np.float64) for a in _inputs(seed, shape, qk_std=math.sqrt(8.0)))
    z = 8.0 * math.sqrt(shape[-1])

    def port(dtype):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
        o = tfm._masked_chunked_vjp(*ts, z, 2, chunk)
        o.backward(torch.tensor(w, dtype=dtype))
        return [o.detach().double().numpy()] + [t.grad.double().numpy() for t in ts]

    f64 = port(torch.float64)
    out, vjp = jax.vjp(lambda *a: jfm._masked_chunked_vjp(*a, z, 2, chunk),
                       *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    jax32 = [np.asarray(out, np.float64)] + [np.asarray(g, np.float64)
                                             for g in vjp(jnp.asarray(w, jnp.float32))]
    return {name: [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, f64)]
            for name, got in (("jax", jax32), ("port", port(torch.float32)))}


def test_port_f32_error_is_within_twice_the_jax_scans():
    """The port's float32 scan lies no further from float64 than twice the JAX
    scan does, in its largest gradient error (the rewind's cancellation
    belongs to the algorithm)."""
    err = scan_grad_errors((1, 2, 256, 128), 64)
    assert max(err["port"][1:]) <= 2.0 * max(err["jax"][1:]), err
    assert max(err["port"]) < 1e-4, err


# ------------------------------------------------------------------ linearmax


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("mask", [True, False])
def test_linearmax_matches_jax(d, mask):
    q, k, v, w = _inputs(80 + d, (1, 2, 200, d))
    got, gg = _torch_vjp(lambda *a: tfm.linearmax(*a, p=1, mask=mask, chunk=64), (q, k, v), w)
    ref, rg = _jax_vjp(lambda *a: jfm.linearmax(*a, p=1, mask=mask, chunk=64), (q, k, v), w)
    _close(got, ref, gg, rg)
    jq, jk = jfm._hack_normalize(jnp.asarray(q), jnp.asarray(k))
    tq, tk = tfm._hack_normalize(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **FWD)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **FWD)
    if mask:  # tests/test_fastmax.py:62
        quad = jfm.polynomial_attention_reference(jq, jk, jnp.asarray(v), p=1,
                                                  normalize_term=1.0)
        np.testing.assert_allclose(got, np.asarray(quad), **QUAD)


def test_linearmax_never_takes_the_fastmax_kernels(monkeypatch):
    """At d <= 64 too linearmax runs the scan, as the reference's does."""
    def refuse(*a, **kw):
        raise AssertionError("linearmax reached the fastmax kernels")

    monkeypatch.setattr(tfm, "fastmax_trainable", refuse)
    q, k, v = (torch.from_numpy(a) for a in _inputs(90, (1, 2, 130, 64), 3))
    out = tfm.linearmax(q, k, v)
    ref = jfm.linearmax(*(jnp.asarray(a.numpy()) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)


# ------------------------------------------------------------------ performer


@pytest.mark.parametrize("d", [32, 128])
def test_performer_matches_jax(d):
    q, k, v, w = _inputs(100 + d, (1, 2, 200, d))
    got, gg = _torch_vjp(lambda *a: tfm.performer(*a, chunk=64), (q, k, v), w)
    ref, rg = _jax_vjp(lambda *a: jfm.performer(*a, chunk=64), (q, k, v), w)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=FWD["rtol"], atol=FWD["atol"] * scale)
    for name, a, b in zip("qkv", gg, rg):
        np.testing.assert_allclose(a, b, rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] * max(np.abs(b).max(), 1.0),
                                   err_msg=f"d{name}")


def _well_conditioned_rows(q, k):
    """Rows where neither floor acts (tests/test_fastmax.py:66)."""
    k_cum = np.cumsum(k, axis=-2) + 1e-6
    den = np.einsum("bhnd,bhnd->bhn", q, k_cum)
    qn = np.sqrt(np.sum(q * q, axis=-1))
    kn = np.sqrt(np.sum(k_cum ** 2, axis=-1))
    floor = np.maximum(tfm.DEN_REL_FLOOR * qn * kn, tfm.DEN_FLOOR)
    return np.abs(den) > np.maximum(floor * 1.01, 1.0)


def test_performer_matches_the_naive_formula_on_well_conditioned_rows():
    """tests/test_fastmax.py:84: the causal formula where the floor is inactive
    and the output within the clip, and chunk invariance there."""
    q, k, v = (a.astype(np.float64) for a in _inputs(110, (2, 3, 200, 16), 3))
    n = q.shape[2]
    s = np.where(np.tril(np.ones((n, n), bool)), np.einsum("bhid,bhjd->bhij", q, k), 0.0)
    naive = np.einsum("bhij,bhjd->bhid", s, v) / np.einsum(
        "bhnd,bhnd->bhn", q, np.cumsum(k, axis=-2) + 1e-6)[..., None]
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)) for a in (q, k, v))
    out = tfm.performer(tq, tk, tv, chunk=64).numpy()
    good = _well_conditioned_rows(q, k) & np.all(np.abs(naive) < 64.0, axis=-1)
    assert good.mean() > 0.5
    np.testing.assert_allclose(out[good], naive[good], atol=5e-2, rtol=5e-2)
    out2 = tfm.performer(tq, tk, tv, chunk=100).numpy()
    np.testing.assert_allclose(out[good], out2[good], atol=5e-2, rtol=5e-2)
    # tests/test_fastmax.py:267: a tiny absolute floor changes no well-conditioned row
    tiny = tfm.performer(tq, tk, tv, chunk=64, den_floor=1e-30).numpy()
    np.testing.assert_array_equal(out[good], tiny[good])


def test_performer_bf16_long_t_is_finite():
    """tests/test_fastmax.py:242: bf16 at (2, 4, 2048, 64) with inputs of std 3,
    whose denominators cross zero many times: a finite bf16 forward, and
    finite f32 gradients of a scalar loss."""
    q, k, v = (torch.from_numpy(3.0 * a) for a in _inputs(120, (2, 4, 2048, 64), 3))
    out = tfm.performer(q.bfloat16(), k.bfloat16(), v.bfloat16(), chunk=128)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    ts = [x.bfloat16().float().requires_grad_(True) for x in (q, k, v)]
    (tfm.performer(*ts, chunk=128) ** 2).mean().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)


def test_performer_training_scale_gradients_bounded():
    """tests/test_fastmax.py:280: the gradient global norm of a 4-layer bf16
    model with performer attention (heads of 64) stays finite and below 1e3,
    where the unconditioned denominator gave 1e10 and more."""
    cfg = Config(name="performer-gnorm", block_size=256, vocab_size=256, padded_vocab_size=256,
                 n_layer=4, n_head=4, n_embd=256, n_query_groups=4, rotary_percentage=1.0,
                 parallel_residual=False, bias=False, _norm_class="RMSNorm",
                 _mlp_class="LLaMAMLP", intermediate_size=512, attn_alg="performer")
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 257)))
    loss = make_loss_fn(cfg, remat=True)(params, batch)
    loss.backward()
    gnorm = math.sqrt(sum(float(p.grad.float().square().sum()) for p in leaves))
    assert math.isfinite(float(loss.detach())) and math.isfinite(gnorm) and gnorm < 1e3, gnorm


# ------------------------------------------------------------------ attention()


@pytest.mark.parametrize("attn_alg,d", [("fastmax", 128), ("fastmax_cuda", 128),
                                        ("linearmax", 64), ("performer", 64)])
def test_attention_arms_match_jax(attn_alg, d):
    """Each linear arm of ``attention()`` with 4 query heads on 2 KV groups:
    output and q, k, v gradients against the JAX ``attention()``."""
    rng = np.random.default_rng(130)
    q = rng.standard_normal((1, 4, 96, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 96, d)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(q.shape).astype(np.float32)
    got, gg = _torch_vjp(lambda *a: tattn.attention(*a, attn_alg=attn_alg, head_size=d),
                         (q, k, v), w)
    ref, rg = _jax_vjp(lambda *a: jattn.attention(*a, attn_alg=attn_alg, head_size=d),
                       (q, k, v), w)
    _close(got, ref, gg, rg)


if __name__ == "__main__":
    torch.set_num_threads(8)
    for shape in ((1, 8, 2048, 64), (1, 4, 2048, 128)):
        errs = scan_grad_errors(shape, tfm._auto_chunk(128, shape[2]))
        for name, e in errs.items():
            print(f"{shape} chunk {tfm._auto_chunk(128, shape[2])} {name} f32 from float64 "
                  f"(o, dq, dk, dv): " + ", ".join(f"{x:.3e}" for x in e))
