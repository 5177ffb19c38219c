"""The port's flash prefill attention (fastmax_tpu_torch/ops/flash_attention.py)
against fastmax_tpu.ops.flash_attention.flash_attention in interpret mode on
the CPU, on the same numpy inputs: causal GQA/MQA, a query chunk at an
offset over a padded cache, kv_len cutting the last rows' keys, ragged T.

Tolerances: float32 atol 2e-5, rtol 1e-4 (the reference's own,
tests/test_flash_attention.py); bfloat16 atol 1e-2, one bf16 ulp (2^-7) of
outputs up to 2 with room for one rounding of p that falls the other way.
The card-only tests hold the CUDA kernel against the plain version with
chip_smoke.py's checks, which also hold bf16 by the mean error (a CPU test
here shows why), and plant faults in a copy of the kernel that the checks
must catch."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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


def _plain_rounding(q, k, v, pos0, kv_len, tile_max=False, truncate=False):
    """flash_attention_plain's arithmetic, step for step, with p rounded to bf16 against the
    max of each block's first 64 keys (``tile_max``) or truncated toward zero (``truncate``)."""
    b, hq, t, d = q.shape
    g, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, g, hq // g, t, d).float()
    qpos = pos0 + torch.arange(t)[:, None]
    m = torch.full((b, g, hq // g, t, 1), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, hq // g, t, d))
    for jb in range(min(math.ceil(min(kv_len, s) / fa.BLOCK_K), (pos0 + t - 1) // fa.BLOCK_K + 1)):
        k0 = jb * fa.BLOCK_K
        kb, vb = k[:, :, k0:k0 + fa.BLOCK_K].float(), v[:, :, k0:k0 + fa.BLOCK_K]
        sc = torch.einsum("bgrtd,bgsd->bgrts", qg, kb) * d ** -0.5
        kpos = k0 + torch.arange(kb.shape[2])[None, :]
        sc = torch.where((kpos <= qpos) & (kpos < kv_len), sc, torch.full_like(sc, fa.NEG_INF))
        m_new = torch.maximum(m, torch.amax(sc[..., :64] if tile_max else sc, dim=-1,
                                            keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        pv = (p.view(torch.int32) & -65536).view(torch.float32) if truncate else \
            p.to(v.dtype).float()
        acc = acc * alpha + torch.einsum("bgrts,bgsd->bgrtd", pv, vb.float())
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.to(q.dtype).reshape(b, hq, t, d)


def test_bf16_mean_gate_sees_a_wrong_rounding_of_p():
    """Why phase 6 holds bf16 outputs by their mean error too. At phase 6's input law and
    its longest-context chunk (B=1, Hq=G=4, S=4096, D=128, T=512 at pos0 3584, seed 0) each
    row averages ~4000 keys and |out| is small, so p rounded against the max of each
    block's first 64 keys instead of the whole block's, or p truncated to bf16 instead of
    rounded to nearest, stays inside the 1e-2 max gate (measured 4.9e-4 for both) and lies
    at least ten times outside the mean gate (1.4e-3 and 3.8e-3 of the mean, 28 and 76
    times 5e-5); the plain version against itself passes both."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(0, 1, 4, 4, 512, 4096, d=128))
    pos0, kv_len = 3584, 4096
    ref = fa.flash_attention_plain(q, k, v, pos0=pos0, kv_len=kv_len)
    assert torch.equal(_plain_rounding(q, k, v, pos0, kv_len), ref)
    ref = ref.float()

    def errors(got):
        err = (got.float() - ref).abs()
        return float(err.max()), float(err.mean() / ref.abs().mean())

    for fault in ({"tile_max": True}, {"truncate": True}):
        worst, mean = errors(_plain_rounding(q, k, v, pos0, kv_len, **fault))
        assert worst <= chip_smoke.FLASH_BF16_ATOL and mean >= 10 * chip_smoke.FLASH_BF16_MEAN, \
            (fault, worst, mean)
    assert errors(ref) == (0.0, 0.0)


# ---------------------------------------------------------------- on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_the_card(dtype):
    """The kernel against the plain version with chip_smoke.py's checks (bf16: the max and
    the mean gates; f32 also within 2e-5 of it): a 7B chunk, GQA with a ragged T, the head
    sizes 192 and 256."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, hq, g, t, s, d, pos0 in ((1, 32, 32, 512, 4096, 128, 1536), (2, 8, 2, 200, 2048, 64, 0),
                                    (1, 8, 4, 256, 2048, 192, 512), (1, 8, 8, 130, 2048, 256, 100)):
        before = build.KERNELS["flash_attention"].launches
        err = chip_smoke.flash_case(torch, gen, b, hq, g, s, d, dtype, t, pos0)["max_abs_err"]
        assert build.KERNELS["flash_attention"].launches == before + 1
        assert err <= (BF16_ATOL if dtype == torch.bfloat16 else 2e-5), err


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.FLASH_KV_CUT)
def test_kernel_honours_kv_len_below_the_frontier_on_the_card(case):
    """The tensor-core kernel (bf16 at D = 64 and 128) and the f32 path with kv_len <
    pos0 + T, so that the last rows lose keys below their causal frontier (and, kv_len <
    pos0, every row does), against the plain version with phase 6's gates."""
    _needs_card()
    b, hq, g, s, d, dt, t, pos0, kv_len = case
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = build.KERNELS["flash_attention"].launches
    err = chip_smoke.flash_case(torch, gen, b, hq, g, s, d, getattr(torch, dt), t, pos0,
                                kv_len)["max_abs_err"]
    assert build.KERNELS["flash_attention"].launches == before + 1
    assert err <= (BF16_ATOL if dt == "bfloat16" else 2e-5), err


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit():
    _needs_card()
    chip_smoke.flash_repeats(torch, torch.Generator(device="cuda").manual_seed(1))


# cases a planted fault is checked on, phase 6's (B, Hq, G, S, D, dtype, T, pos0): a whole
# 2048-token prompt (the causal frontier crosses every block) and the longest-context chunk
WHOLE = (1, 32, 32, 4096, 128, torch.bfloat16, 2048, 0)
LONG = (1, 32, 32, 4096, 128, torch.bfloat16, 512, 3584)
# faults planted in a copy of csrc/, each in the tensor-core kernel: (the code as written,
# as planted, case)
FAULTS = {
    "K3 diagonal unmasked": ("s[j][e] = key > lim[e >> 1] ? kNegInf : v;",
                             "s[j][e] = key > lim[e >> 1] + 1 ? kNegInf : v;", WHOLE),
    "K3 p against the first tile's max": (
        "for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);",
        "for (int e = 0; e < 4; ++e) if (j < 8) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);",
        LONG),
    "K3 p truncated": (
        "a[r] = pack_bf16x2(s[j + (r >> 1)][2 * (r & 1)], s[j + (r >> 1)][2 * (r & 1) + 1]);",
        "a[r] = (__float_as_uint(s[j + (r >> 1)][2 * (r & 1)]) >> 16) | "
        "(__float_as_uint(s[j + (r >> 1)][2 * (r & 1) + 1]) & 0xffff0000u);", LONG),
    "K3 last key block skipped": ("for (int k0 = 0; k0 < kv_hi; k0 += kBK) {",
                                  "for (int k0 = 0; k0 + kBK < kv_hi; k0 += kBK) {", LONG),
}


def _planted(tmp_path, fault):
    written, planted, _ = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    real = build.KERNELS["flash_attention"]
    text = (src / real.source.name).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {real.source.name} once"
    (src / real.source.name).write_text(text.replace(written, planted))
    return build.Kernel(real.name, str(src / real.source.name), real.replaces, real.entry,
                        real.argtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_planted_fault(fault, tmp_path, monkeypatch):
    """chip_smoke.py's check fails for a tensor-core K3 built with the next key past the
    diagonal unmasked, with p rounded against the max of each block's first 64-key tile
    instead of the whole block's, with p truncated to bf16 (toward zero, not to nearest
    even), or with the last key block a tile needs skipped. The two rounding faults move
    the output by rounding alone, which only the mean gate sees (this test's print on an
    H100: the first tile's max 4.9e-4 at most, under the max gate, and 1.4e-3 of the mean,
    28 times the mean gate; p truncated 9.8e-4 and 3.8e-3, 76 times)."""
    _needs_card()
    faulty = _planted(tmp_path, fault)
    gen = torch.Generator(device="cuda").manual_seed(5)
    case = FAULTS[fault][2]
    chip_smoke.flash_case(torch, gen, *case)  # sound
    monkeypatch.setitem(build.KERNELS, "flash_attention", faulty)
    with pytest.raises(AssertionError, match="K3") as caught:
        chip_smoke.flash_case(torch, gen, *case)
    print(f"{fault}: {caught.value}")


def test_kernel_source_holds_the_planted_lines():
    """The lines the card's fault tests plant faults in are in K3's source once each (so a
    rewrite of the kernel does not silently disarm them)."""
    text = build.KERNELS["flash_attention"].source.read_text()
    for written, *_ in FAULTS.values():
        assert text.count(written) == 1, written
