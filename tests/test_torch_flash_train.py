"""The port's trainable causal attention (ops/flash_attention.py training
entries, ops/blockwise_attention.py, the quadratic route of ops/attention.py)
against the JAX package on the CPU, and the kernels K6/K7 against their plain
versions on the card.

On the CPU the entries run their plain versions; the JAX package runs its
Pallas kernels in interpret mode. q and k are drawn at std sqrt(3), so the
scores q.k / sqrt(D) have a standard deviation of about 3 and the softmax is
far from uniform. Tolerances: float32 the reference's own
(tests/test_flash_attention.py:95,119): out and lse atol 2e-5 / rtol 1e-4,
gradients atol 3e-4 / rtol 1e-3. bfloat16 outputs are rounded values, and two
f32 sums in different orders round to neighbouring bf16 values now and then:
each element within one bf16 ulp of its own value (rtol 2^-7) plus one ulp
of the largest value (atol 2^-8 of it: a gradient element far below the
largest sums rounded ds terms that cancel, and can lie several of its own
ulps off), and at most 1 % of the elements off at all (measured: under
0.6 %).
"""

import math
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fastmax_tpu.ops import attention as jattn
from fastmax_tpu.ops import blockwise_attention as jbw
from fastmax_tpu.ops import flash_attention as jfa
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import attention as tattn
from fastmax_tpu_torch.ops import flash_attention as tfa
from fastmax_tpu_torch.ops.blockwise_attention import blockwise_attention

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
QK_STD = 3 ** 0.5
F32 = {"fwd": (2e-5, 1e-4), "grad": (3e-4, 1e-3)}
BF16_RTOL, BF16_OFF = 2.0 ** -7, 1e-2


def _inputs(shape, seed, kv_shape=None):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or shape
    return [rng.standard_normal(s).astype(np.float32) * std
            for s, std in ((shape, QK_STD), (kv_shape, QK_STD), (kv_shape, 1.0), (shape, 1.0))]


def _close(got, want, kind, bf16, what=""):
    """``what`` names the array (out, lse, dq, dk, dv) in the failure message,
    with the largest error against its allowance."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol, rtol = F32[kind]
    if bf16:
        atol, rtol = 2.0 ** -8 * float(np.abs(want).max()), BF16_RTOL
    err = np.abs(got - want)
    worst = float(np.max(err / (atol + rtol * np.abs(want))))
    msg = (f"{what}: max abs err {float(err.max()):.3e}, worst err / allowance {worst:.3f} "
           f"(atol {atol:.3e}, rtol {rtol})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=msg)
    if bf16:
        assert float(np.mean(got != want)) <= BF16_OFF, msg


def _jax_side(fn, q, k, v, w, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(x, jd) for x in (q, k, v)]
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * w), (0, 1, 2))(*args)
    return out, grads


def _torch_side(fn, q, k, v, w, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(512, 64), (1024, 64), (512, 256)],
                         ids=["512", "1024", "512-d256"])
@pytest.mark.parametrize("entry", ["fused", "trainable"])
def test_plain_flash_matches_jax_interpret(entry, t, d, dtype):
    """out, lse, dq, dk, dv of the plain versions against the JAX entries in
    interpret mode (the fused one with T=1024 runs two 512-key blocks), at
    head size 64 and at Gemma's 256."""
    q, k, v, w = _inputs((1, 2, t, d), seed=t)
    scale = d ** -0.5
    bf16 = dtype == torch.bfloat16
    if entry == "fused":
        jfn = lambda q, k, v: jfa.flash_attention_fused(q, k, v, None, True)
        jlse = lambda *a: jfa._whole_fwd(*a, scale, True)[1]
        tfn, block = tfa.flash_attention_fused, tfa._fused_block(t)
    else:
        jfn = lambda q, k, v: jfa.flash_attention_trainable(q, k, v, None, 128, 128, True)
        jlse = lambda *a: jfa._fwd_lse(*a, scale, 128, 128, True)[1]
        tfn, block = tfa.flash_attention_trainable, 128
    jout, jgrads = _jax_side(jfn, q, k, v, w, dtype)
    tout, tgrads = _torch_side(tfn, q, k, v, w, dtype)
    assert tout.dtype == dtype
    _close(tout, jout, "fwd", bf16, "out")
    jd = jnp.bfloat16 if bf16 else jnp.float32
    want_lse = jlse(*(jnp.asarray(x, jd) for x in (q, k, v))).reshape(1, 2, t)
    _, tlse = tfa.flash_train_fwd_plain(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                        scale, block)
    _close(tlse, want_lse, "fwd", False, "lse")
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _close(a, b, "grad", bf16, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blockwise_matches_jax(dtype):
    q, k, v, w = _inputs((1, 2, 512, 32), seed=7)
    jout, jgrads = _jax_side(lambda q, k, v: jbw.blockwise_attention(q, k, v, None, 256),
                             q, k, v, w, dtype)
    tout, tgrads = _torch_side(lambda q, k, v: blockwise_attention(q, k, v, None, 256),
                               q, k, v, w, dtype)
    bf16 = dtype == torch.bfloat16
    _close(tout, jout, "fwd", bf16)
    for a, b in zip(tgrads, jgrads):
        _close(a, b, "grad", bf16)


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """The JAX dispatch's flash entries in interpret mode (the pattern of
    tests/test_flash_attention.py:135-157)."""
    fused, trainable = jfa.flash_attention_fused, jfa.flash_attention_trainable
    monkeypatch.setattr(jfa, "flash_attention_fused",
                        lambda q, k, v, scale=None, interpret=False: fused(q, k, v, scale, True))
    monkeypatch.setattr(jfa, "flash_attention_trainable",
                        lambda q, k, v, scale=None, bq=128, bk=128, interpret=False:
                        trainable(q, k, v, scale, bq, bk, True))


@pytest.mark.parametrize("route,hq,g,d", [("flash2", 4, 2, 64), ("flash", 2, 1, 64),
                                          ("blockwise", 4, 2, 32)])
def test_dispatch_pads_and_routes_like_jax(route, hq, g, d, monkeypatch, jax_flash_interpret):
    """attention() at T=1088 (padded to 1536 for flash2, 1152 for flash, 1280
    for the blockwise block of 256 at D=32, which flash does not take),
    forward and gradients, against the JAX dispatch."""
    monkeypatch.setenv("FASTMAX_TPU_TRAIN_ATTN", route)
    monkeypatch.setattr(jattn, "TRAIN_ATTN", route)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", route)
    monkeypatch.setattr(jattn, "BLOCKWISE_BLOCK", 256)
    monkeypatch.setattr(tattn, "BLOCKWISE_BLOCK", 256)
    t = 1088
    q, k, v, w = _inputs((1, hq, t, d), seed=11, kv_shape=(1, g, t, d))
    jfn = lambda q, k, v: jattn.attention(q, k, v, attn_alg="quadratic", head_size=d)
    tfn = lambda q, k, v: tattn.attention(q, k, v, attn_alg="quadratic", head_size=d)
    jout, jgrads = _jax_side(jfn, q, k, v, w, torch.float32)
    tout, tgrads = _torch_side(tfn, q, k, v, w, torch.float32)
    assert tuple(tout.shape) == (1, hq, t, d)
    _close(tout, jout, "fwd", False)
    for a, b in zip(tgrads, jgrads):
        _close(a, b, "grad", False)


def test_route_choices(monkeypatch):
    """flash2 takes the fused entry unless _fused_eligible refuses (Llama-2-7B
    at T=4096: T*D = 524288), then blockwise; D % 64 != 0 takes blockwise;
    auto at D % 64 != 0 takes blockwise untimed; below BLOCKWISE_MIN_T the
    dense softmax runs."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention_fused", lambda *a, **k: calls.append("flash2"))
    monkeypatch.setattr(tattn, "flash_attention_trainable", lambda *a, **k: calls.append("flash"))
    monkeypatch.setattr(tattn, "blockwise_attention", lambda *a, **k: calls.append("blockwise"))
    q = torch.zeros((1, 1, 4096, 128))
    tattn._long_causal(q, q, q, 128, False)
    q = torch.zeros((1, 1, 2048, 128))
    tattn._long_causal(q, q, q, 128, False)
    q = torch.zeros((1, 1, 1024, 96))
    tattn._long_causal(q, q, q, 96, False)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", "flash")
    tattn._long_causal(torch.zeros((1, 1, 1024, 64)), *[torch.zeros((1, 1, 1024, 64))] * 2, 64,
                       False)
    assert calls == ["blockwise", "flash2", "blockwise", "flash"]
    assert not tfa._fused_eligible(4096, 128) and tfa._fused_eligible(2048, 128)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", "auto")
    tattn._long_causal(q, q, q, 96, False)  # "auto" at D % 64 != 0: blockwise, nothing timed
    q = torch.randn((1, 2, 64, 64))
    assert tattn.attention(q, q, q, attn_alg="quadratic", head_size=64).shape == q.shape
    assert calls == ["blockwise", "flash2", "blockwise", "flash", "blockwise"]


def test_entries_refuse_unpadded_lengths():
    q = torch.zeros((1, 1, 640, 64))
    with pytest.raises(ValueError, match="pad"):
        tfa.flash_attention_fused(q, q, q)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention_trainable(q[:, :, :200], q[:, :, :200], q[:, :, :200])
    with pytest.raises(ValueError, match="pad"):
        blockwise_attention(q, q, q, None, 512)


# ---------------------------------------------------------------- on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape", [("fused", (2, 4, 512, 64)), ("fused", (1, 3, 1024, 128)),
                                         ("trainable", (2, 2, 384, 192)),
                                         ("fused", (1, 2, 200, 256)),
                                         ("trainable", (1, 4, 640, 128)),
                                         ("fused", (1, 2, 1024, 256)),
                                         ("trainable", (1, 2, 640, 256))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_the_card(entry, shape, dtype):
    """K6 and K7 through the entries against plain=True, with chip_smoke.py's
    checks and tolerances: every head size the route sends, a ragged T=200
    in the fused entry's one whole-T block, 384 and 640 rows (tiles and
    blocks that do not divide T evenly); at D = 256 (bf16: K7's warp pairs)
    also two 512-key blocks and 128-key blocks over ragged tiles."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    before = build.launch_counts()
    chip_smoke.flash_train_case(torch, gen, entry, shape, dtype, f64=False)
    after = build.launch_counts()
    # K6: the entry's forward and the case's own call for lse; K7: the backward
    assert after["flash_train_fwd"] - before["flash_train_fwd"] == 2
    assert after["flash_train_bwd"] - before["flash_train_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 1024, 128), (1, 4, 1024, 256)])
def test_kernels_repeat_bit_for_bit(shape):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    chip_smoke.flash_train_repeats(torch, gen, shape, torch.bfloat16)


# the case a planted fault is checked on: bf16 at D = 128 runs the tensor-core kernels, at
# D = 256 K6's tensor-core kernel and K7's warp pairs; at D = 192 the FMA kernels
TC_CASE = ("fused", (2, 4, 1024, 128), torch.bfloat16)
TC256_CASE = ("fused", (1, 8, 1024, 256), torch.bfloat16)
FMA_CASE = ("fused", (1, 8, 1024, 192), torch.bfloat16)
# faults planted in a copy of csrc/: (kernel, file, the code as written, as planted, case)
FAULTS = {
    "K6 diagonal unmasked": ("flash_train_fwd", "flash_train_fwd.cu",
                             "const int lim = min(row, kend - 1);",
                             "const int lim = kend - 1;", TC_CASE),
    "K6 p against the first tile's max": (
        "flash_train_fwd", "flash_train_fwd.cu",
        "for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);",
        "for (int e = 0; e < 4; ++e) if (kt == k0) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);",
        TC_CASE),
    "K6 p against the first tile's max, D = 256": (
        "flash_train_fwd", "flash_train_fwd.cu",
        "for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);",
        "for (int e = 0; e < 4; ++e) if (kt == k0) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);",
        TC256_CASE),
    "K7 diagonal unmasked": ("flash_train_bwd", "flash_train_bwd.cu",
                             "const bool visible = key <= query && query < t_len;",
                             "const bool visible = query < t_len;", TC_CASE),
    "K7 delta dropped": ("flash_train_bwd", "flash_train_bwd.cu",
                         "return p * (dp - delta);",
                         "return p * dp;", TC_CASE),
    "K7 p truncated before dv": (
        "flash_train_bwd", "flash_train_bwd.cu",
        "return pack_bf16x2(lo, hi);",
        "return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);", TC_CASE),
    "K7 p truncated before the pair exchange, D = 256": (
        "flash_train_bwd", "flash_train_bwd.cu",
        "return pack_bf16x2(lo, hi);",
        "return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);",
        TC256_CASE),
    "K7 pair exchange: a warp's own p for its partner's rows, D = 256": (
        "flash_train_bwd", "flash_train_bwd.cu",
        "get_frags(pa, slot(h, 0), lane);",
        "get_frags(pa, slot(half, 0), lane);", TC256_CASE),
    "K7 p unrounded before dv": ("flash_train_bwd", "flash_train_bwd.cu",
                                 "ps[row * PS + col] = round_to<T>(p);",
                                 "ps[row * PS + col] = p;", FMA_CASE),
}


def _planted(tmp_path, fault):
    name, source, written, planted, _ = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    text = (src / source).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {source} once"
    (src / source).write_text(text.replace(written, planted))
    real = build.KERNELS[name]
    return name, build.Kernel(name, str(src / source), real.replaces, real.entry, real.argtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_planted_fault(fault, tmp_path, monkeypatch):
    """chip_smoke.py's check fails for a kernel built with the diagonal block
    unmasked or delta dropped from ds; for a K7 whose p is truncated to bf16
    (toward zero, not to nearest even) before dv in the tensor-core kernels
    (at D = 256 before the pair's exchange in shared memory), or left
    unrounded there in the FMA kernel (bf16, D = 192); for a K7 whose warps
    at D = 256 add their own p^T in place of their partner's rows; and for a
    K6 that rounds p against the max of each online block's first 64-key
    tile instead of the whole block's (pass 1 cut short), at D = 128 and
    256. The rounding faults move
    an output by rounding alone, which only the mean gate sees (this test's
    print on an H100, K6: 3.8e-3 of the largest value, under the max gate, and
    1.2e-3 of the mean, 23 times the mean gate; K7 p truncated: 3.9e-3 and
    3.7e-3, 74 times)."""
    _needs_card()
    name, faulty = _planted(tmp_path, fault)
    gen = torch.Generator(device="cuda").manual_seed(5)
    case = FAULTS[fault][4]
    chip_smoke.flash_train_case(torch, gen, *case, f64=False)  # sound
    monkeypatch.setitem(build.KERNELS, name, faulty)
    with pytest.raises(AssertionError, match=fault[:2]) as caught:
        chip_smoke.flash_train_case(torch, gen, *case, f64=False)
    print(f"{fault}: {caught.value}")


def test_bf16_mean_gate_sees_a_rounding_against_another_max():
    """Why phase 9 holds bf16 outputs by their mean error too: p rounded
    against the running max of 64-key blocks instead of the fused entry's
    whole 512-key block moves ``out`` by rounding alone. At phase 9's input
    law (q, k at std sqrt(3), v at 1), B=1 H=4 T=512 D=128, it stays inside
    the max gate (measured 1.8e-3 of the largest value, 0.23 of 2^-7) and
    lies outside the mean gate (2.9e-4 of the mean, 5.8 times 5e-5; the test
    asks for twice the gate); the plain version against itself passes both."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs((1, 4, 512, 128), seed=0))
    scale, fused = 128 ** -0.5, tfa._fused_block(512)
    ref = tfa.flash_train_fwd_plain(q, k, v, scale, fused)[0].float()

    def rel(got):
        err = (got.float() - ref).abs()
        return float(err.max() / ref.abs().max()), float(err.mean() / ref.abs().mean())

    max_gate, mean_gate = chip_smoke.FLASH_TRAIN_REL["bfloat16"]["out"], \
        chip_smoke.FLASH_TRAIN_BF16_MEAN
    worst, mean = rel(tfa.flash_train_fwd_plain(q, k, v, scale, 64)[0])
    assert worst <= max_gate and mean > 2 * mean_gate, (worst, mean)
    worst, mean = rel(tfa.flash_train_fwd_plain(q, k, v, scale, fused)[0])
    assert worst <= max_gate and mean <= mean_gate, (worst, mean)


def _bwd_rounding_p(q, k, v, do, lse, delta, scale, round_p):
    """flash_train_bwd_plain's arithmetic, step for step, with p rounded to
    bf16 by ``round_p`` (f32 in, f32 of bf16 values out) before dv."""
    b, h, t, d = q.shape
    dq = torch.zeros((b, h, t, d))
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for q0 in range(0, t, tfa.PLAIN_BWD_ROWS):
        q1 = min(q0 + tfa.PLAIN_BWD_ROWS, t)
        qi, doi = q[:, :, q0:q1].float(), do[:, :, q0:q1].float()
        kk, vk = k[:, :, :q1].float(), v[:, :, :q1].float()
        s = torch.einsum("bhid,bhjd->bhij", qi, kk) * scale
        mask = torch.arange(q1)[None, :] <= torch.arange(q0, q1)[:, None]
        p = torch.where(mask, torch.exp(s - lse[:, :, q0:q1, None]), torch.zeros_like(s))
        dp = torch.einsum("bhid,bhjd->bhij", doi, vk)
        ds = p * (dp - delta[:, :, q0:q1, None])
        dv[:, :, :q1] += torch.einsum("bhij,bhid->bhjd", round_p(p), doi)
        dk[:, :, :q1] += torch.einsum("bhij,bhid->bhjd", ds.to(q.dtype).float(), qi)
        dq[:, :, q0:q1] = torch.einsum("bhij,bhjd->bhid", ds.to(k.dtype).float(), kk)
    return (dq * scale).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def test_bf16_mean_gate_sees_a_truncated_p_in_the_backward():
    """Why phase 9 holds K7's bf16 gradients by their mean error too: p
    truncated to bf16 (toward zero) before dv, where the reference rounds it
    to nearest even, moves dv by rounding alone. At phase 9's input law,
    B=1 H=4 T=512 D=128, it stays inside the max gate (measured 4.7e-3 of the
    largest value, 0.61 of 2^-7) and lies outside the mean gate (3.6e-3 of
    the mean, 73 times 5e-5; the test asks for 10 times); the same arithmetic
    rounding to nearest passes both gates (it equals the plain version)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs((1, 4, 512, 128), seed=0))
    scale = 128 ** -0.5
    out, lse = tfa.flash_train_fwd_plain(q, k, v, scale, tfa._fused_block(512))
    delta = torch.sum(do.float() * out.float(), dim=-1)
    ref = tfa.flash_train_bwd_plain(q, k, v, do, lse, delta, scale)

    def rel(got, want):
        err = (got.float() - want.float()).abs()
        return float(err.max() / want.float().abs().max()), \
            float(err.mean() / want.float().abs().mean())

    max_gate, mean_gate = chip_smoke.FLASH_TRAIN_REL["bfloat16"]["grad"], \
        chip_smoke.FLASH_TRAIN_BF16_MEAN
    truncated = _bwd_rounding_p(q, k, v, do, lse, delta, scale,
                                lambda p: (p.view(torch.int32) & -65536).view(torch.float32))
    worst, mean = rel(truncated[2], ref[2])
    assert worst <= max_gate and mean >= 10 * mean_gate, (worst, mean)
    nearest = _bwd_rounding_p(q, k, v, do, lse, delta, scale,
                              lambda p: p.to(torch.bfloat16).float())
    for got, want in zip(nearest, ref):
        worst, mean = rel(got, want)
        assert worst <= max_gate and mean <= mean_gate, (worst, mean)


def test_kernel_sources_hold_the_planted_lines():
    """The lines the card's fault tests plant faults in are in the sources
    once each (so a rewrite of a kernel does not silently disarm them)."""
    for name, source, written, *_ in FAULTS.values():
        assert (build.CSRC_DIR / source).read_text().count(written) == 1, (source, written)
        assert build.KERNELS[name].source.name == source
    assert math.lcm(tfa.DEFAULT_BLOCK_Q, tfa.DEFAULT_BLOCK_K) == 128


def test_step_profiles_attribute_every_kernel_function():
    """chip_smoke.py's step profiles sum device time by kernel from the
    names of the __global__ functions: each one in the sources of K1-K9, K11
    and K12 falls in its own kernel's group, so a second function (K7's
    tensor-core kernel, K4's and K5's finishing passes) is not counted as
    "other"."""
    kernels = {**build.KERNELS, **build.TOOL_KERNELS}
    for label, keys in chip_smoke.KERNEL_GROUPS:
        if label.split()[1] not in kernels:  # the library's group
            continue
        source = kernels[label.split()[1]].source.read_text()
        functions = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                               source)
        assert functions, label
        for fn in functions:
            assert any(k in fn for k in keys), (label, fn)
