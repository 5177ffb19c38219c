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

torch.set_num_threads(2)
QK_STD = 3 ** 0.5
F32 = {"fwd": (2e-5, 1e-4), "grad": (3e-4, 1e-3)}
BF16_RTOL, BF16_OFF = 2.0 ** -7, 1e-2


def _inputs(shape, seed, kv_shape=None):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or shape
    return [rng.standard_normal(s).astype(np.float32) * std
            for s, std in ((shape, QK_STD), (kv_shape, QK_STD), (kv_shape, 1.0), (shape, 1.0))]


def _close(got, want, kind, bf16):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    atol, rtol = F32[kind]
    if not bf16:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        return
    np.testing.assert_allclose(got, want, atol=2.0 ** -8 * float(np.abs(want).max()),
                               rtol=BF16_RTOL)
    assert float(np.mean(got != want)) <= BF16_OFF


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
@pytest.mark.parametrize("t", [512, 1024])
@pytest.mark.parametrize("entry", ["fused", "trainable"])
def test_plain_flash_matches_jax_interpret(entry, t, dtype):
    """out, lse, dq, dk, dv of the plain versions against the JAX entries in
    interpret mode (the fused one with T=1024 runs two 512-key blocks)."""
    q, k, v, w = _inputs((1, 2, t, 64), seed=t)
    scale = 64 ** -0.5
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
    _close(tout, jout, "fwd", bf16)
    jd = jnp.bfloat16 if bf16 else jnp.float32
    want_lse = jlse(*(jnp.asarray(x, jd) for x in (q, k, v))).reshape(1, 2, t)
    _, tlse = tfa.flash_train_fwd_plain(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                        scale, block)
    _close(tlse, want_lse, "fwd", False)
    for a, b in zip(tgrads, jgrads):
        _close(a, b, "grad", bf16)


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
    auto raises; below BLOCKWISE_MIN_T the dense softmax runs."""
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
    with pytest.raises(NotImplementedError, match="auto"):
        tattn._long_causal(q, q, q, 96, False)
    q = torch.randn((1, 2, 64, 64))
    assert tattn.attention(q, q, q, attn_alg="quadratic", head_size=64).shape == q.shape
    assert calls == ["blockwise", "flash2", "blockwise", "flash"]


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
                                         ("trainable", (1, 4, 640, 128))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_the_card(entry, shape, dtype):
    """K6 and K7 through the entries against plain=True, with chip_smoke.py's
    checks and tolerances: every head size the route sends, a ragged T=200
    in the fused entry's one whole-T block, 384 and 640 rows (tiles and
    blocks that do not divide T evenly)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    before = build.launch_counts()
    chip_smoke.flash_train_case(torch, gen, entry, shape, dtype, f64=False)
    after = build.launch_counts()
    # K6: the entry's forward and the case's own call for lse; K7: the backward
    assert after["flash_train_fwd"] - before["flash_train_fwd"] == 2
    assert after["flash_train_bwd"] - before["flash_train_bwd"] == 1


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    chip_smoke.flash_train_repeats(torch, gen, (2, 4, 1024, 128), torch.bfloat16)


# faults planted in a copy of csrc/: (kernel, file, the code as written, as planted)
FAULTS = {
    "K6 diagonal unmasked": ("flash_train_fwd", "flash_train_fwd.cu",
                             "const bool ok = key <= qpos && key < kend;",
                             "const bool ok = key < kend;"),
    "K7 diagonal unmasked": ("flash_train_bwd", "flash_train_bwd.cu",
                             "const bool ok = kpos <= qpos && qpos < t_len;",
                             "const bool ok = qpos < t_len;"),
    "K7 delta dropped": ("flash_train_bwd", "flash_train_bwd.cu",
                         "const float ds = p * (dp[i][c] - delta);",
                         "const float ds = p * dp[i][c];"),
    "K7 p unrounded before dv": ("flash_train_bwd", "flash_train_bwd.cu",
                                 "ps[row * PS + col] = round_to<T>(p);",
                                 "ps[row * PS + col] = p;"),
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
def test_checks_catch_a_planted_fault(fault, tmp_path, monkeypatch):
    """chip_smoke.py's check fails for a kernel built with the diagonal block
    unmasked, delta dropped from ds, or p left unrounded before dv (bf16)."""
    _needs_card()
    name, faulty = _planted(tmp_path, fault)
    gen = torch.Generator(device="cuda").manual_seed(5)
    case = ("fused", (2, 4, 1024, 128), torch.bfloat16)
    chip_smoke.flash_train_case(torch, gen, *case, f64=False)  # sound
    monkeypatch.setitem(build.KERNELS, name, faulty)
    with pytest.raises(AssertionError, match=fault[:2]) as caught:
        chip_smoke.flash_train_case(torch, gen, *case, f64=False)
    print(f"{fault}: {caught.value}")


def test_kernel_sources_hold_the_planted_lines():
    """The lines the card's fault tests plant faults in are in the sources
    once each (so a rewrite of a kernel does not silently disarm them)."""
    for name, source, written, _ in FAULTS.values():
        assert (build.CSRC_DIR / source).read_text().count(written) == 1, (source, written)
        assert build.KERNELS[name].source.name == source
    assert math.lcm(tfa.DEFAULT_BLOCK_Q, tfa.DEFAULT_BLOCK_K) == 128
