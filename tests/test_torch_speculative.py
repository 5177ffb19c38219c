"""The port's speculative decoding (fastmax_tpu_torch/inference/speculative.py
and the rejection rules of ops/sampling.py) against fastmax_tpu's on the CPU:
the counterparts of tests/test_speculative.py, with the same tiny GPT-NeoX
(the JAX package's init, carried across), plus ngram_draft and _commit
against the JAX functions on seeded histories, and the greedy decoders'
tokens and verify counts against the JAX decoders'.

Greedy paths are compared as tokens (float32 on the CPU: no near-ties).
Sampled paths draw their noise from a torch.Generator where the reference
splits a jax.random key, so they are compared as distributions, at the
reference's 4.5/sqrt(n)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference import speculative as jspec
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu_torch.inference import speculative as tspec
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.ops.sampling import (filtered_log_probs, speculative_accept,
                                            speculative_accept_logq)

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
# tests/test_speculative.py's setups
TARGET = dict(block_size=128, vocab_size=96, padded_vocab_size=96, n_layer=2, n_head=4,
              n_embd=64, rotary_percentage=1.0)
DRAFT = dict(block_size=128, vocab_size=96, padded_vocab_size=96, n_layer=1, n_head=2,
             n_embd=32, rotary_percentage=1.0)


@functools.lru_cache(maxsize=None)
def _engines(which: str):
    """(JAX engine, port engine) over the same float32 weights."""
    cfg, seed = (TARGET, 0) if which == "target" else (DRAFT, 7)
    params = jgpt.init_params(JaxConfig(**cfg), jax.random.PRNGKey(seed), jnp.float32)
    jeng = JaxEngine(JaxConfig(**cfg), params, max_seq_length=128, batch_size=1)
    teng = InferenceEngine(Config(**cfg), from_numpy_params(jax.tree.map(np.asarray, params),
                                                            "cpu"),
                           max_seq_length=128, batch_size=1, device="cpu")
    return jeng, teng


def _greedy(teng, prompt, n):
    return teng.generate(torch.as_tensor(prompt), n, temperature=0.0).numpy()


def _prompt(name, seed=0):
    if name == "repetitive":
        return np.tile([3, 4, 5, 6], 6).astype(np.int32)
    return np.random.default_rng(seed).integers(1, 96, (16,)).astype(np.int32)


# ------------------------------------------------------- draft and commit rules


def test_ngram_draft_lookup():
    hist = torch.tensor([5, 6, 7, 8, 9, 5, 6, 0, 0, 0, 0, 0], dtype=torch.int32)
    # current bigram (5, 6) at pos 7 matches hist[0:2]; the draft is what followed it
    assert tspec.ngram_draft(hist, 7, 3, hist.shape[0]).tolist() == [7, 8, 9]
    # no match: the last token repeated
    hist2 = torch.tensor([1, 2, 3, 4, 0, 0], dtype=torch.int32)
    assert tspec.ngram_draft(hist2, 4, 3, hist2.shape[0]).tolist() == [4, 4, 4]


@functools.lru_cache(maxsize=None)
def _jax_draft(k: int, s: int):
    return jax.jit(lambda hist, pos: jspec.ngram_draft(hist, pos, k, s))


@functools.lru_cache(maxsize=None)
def _jax_commit(k: int, with_eos: bool):
    if with_eos:
        return jax.jit(lambda h, p, c, a, e, lim: jspec._commit(h, p, c, a, k, e, lim))
    return jax.jit(lambda h, p, c, a, e, lim: jspec._commit(h, p, c, a, k, None, lim))


def test_ngram_draft_matches_the_reference():
    """Seeded histories over a small alphabet (many matches), every pos up to
    the end, so that a draft's clamped start reads entries past pos."""
    rng = np.random.default_rng(0)
    s = 32
    for trial in range(40):
        k = int(rng.integers(1, 6))
        hist = rng.integers(0, 4 if trial % 2 else 9, s).astype(np.int32)
        for pos in range(1, s + 1):
            want = np.asarray(_jax_draft(k, s)(jnp.asarray(hist), jnp.asarray(pos)))
            got = tspec.ngram_draft(torch.from_numpy(hist), pos, k, s).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"hist {hist} pos {pos} k {k}")
    # the draft reads past pos: the best match ends within k of the history's end
    hist = np.asarray([1, 2, 3, 9, 9, 1, 2, 7, 7, 7], np.int32)
    got = tspec.ngram_draft(torch.from_numpy(hist), 7, 4, 10).tolist()
    assert got == [3, 9, 9, 1] and got == np.asarray(
        jspec.ngram_draft(jnp.asarray(hist), jnp.asarray(7), 4, 10)).tolist()


def test_commit_matches_the_reference():
    """Accepted counts, eos in and past the accepted run, and the budget
    ``pos + i < limit`` at and past its edge."""
    rng = np.random.default_rng(1)
    s = 49  # 40 positions and k+1 slack for k up to 8
    for trial in range(300):
        k = int(rng.integers(1, 9))
        pos = int(rng.integers(2, 40))
        hist = rng.integers(0, 20, s).astype(np.int32)
        cand = rng.integers(0, 6, k + 1).astype(np.int32)
        a = int(rng.integers(0, k + 1))
        eos_id = None if trial % 3 == 0 else int(rng.integers(0, 6))
        limit = int(rng.integers(pos, 41)) if trial % 2 else 40
        jh, jp, jd = _jax_commit(k, eos_id is not None)(
            jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(cand), jnp.asarray(a),
            jnp.asarray(-1 if eos_id is None else eos_id), jnp.asarray(limit))
        th, tp, td = tspec._commit(torch.from_numpy(hist.copy()), pos, torch.from_numpy(cand),
                                   torch.tensor(a), k, eos_id, limit)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert (int(tp), bool(td)) == (int(jp), bool(jd)), (trial, pos, a, eos_id, limit)


# ------------------------------------------------------------ greedy decoding


@pytest.mark.parametrize("k", [1, 4, 8])
def test_speculative_matches_greedy(k):
    """The port's greedy speculation gives the port engine's greedy tokens,
    the JAX decoder's tokens, and the JAX decoder's verify count."""
    jeng, teng = _engines("target")
    for name in ("random", "repetitive"):
        prompt = _prompt(name)
        ref = _greedy(teng, prompt, 80)
        jax_ref = np.asarray(jeng.generate(jnp.asarray(prompt), 80, temperature=0.0,
                                           key=jax.random.PRNGKey(9)))
        np.testing.assert_array_equal(ref, jax_ref, err_msg="the two engines")
        spec = tspec.SpeculativeDecoder(teng, k=k)
        got = spec.generate(torch.from_numpy(prompt), 80).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} k={k}")
        jspec_ = jspec.SpeculativeDecoder(jeng, k=k)
        np.testing.assert_array_equal(np.asarray(jspec_.generate(jnp.asarray(prompt), 80)), got)
        assert spec.last_steps == jspec_.last_steps <= 80 - len(prompt)
        if name == "repetitive" and k > 1:
            assert spec.last_steps < 80 - len(prompt) - 1  # the lookup's drafts land


def test_speculative_eos_truncation():
    _, teng = _engines("target")
    prompt = np.arange(1, 17, dtype=np.int32)
    ref = _greedy(teng, prompt, 64)
    eos = int(ref[0, 16 + 3])  # the 4th generated token as a fake eos: both paths stop there
    ref_eos = teng.generate(torch.from_numpy(prompt), 64, temperature=0.0, eos_id=eos).numpy()
    got = tspec.SpeculativeDecoder(teng, k=6).generate(torch.from_numpy(prompt), 64,
                                                       eos_id=eos).numpy()
    np.testing.assert_array_equal(got, ref_eos)
    assert got[0, -1] == eos


def test_speculative_budget_guard():
    _, teng = _engines("target")
    spec = tspec.SpeculativeDecoder(teng, k=8)
    with pytest.raises(ValueError, match="headroom"):
        spec.generate(torch.tensor([1, 2, 3]), 128)
    # the last position the budget allows: 119 + 9 = 128
    assert spec.generate(torch.tensor([1, 2, 3]), 119).shape == (1, 119)


def test_decoders_refuse_batches_and_linear_arms():
    jeng, teng = _engines("target")
    two = InferenceEngine(Config(**TARGET), teng.params, max_seq_length=128, batch_size=2,
                          device="cpu")
    with pytest.raises(ValueError, match="batch_size=1"):
        tspec.SpeculativeDecoder(two)
    lin = InferenceEngine(Config(**TARGET, attn_alg="fastmax"), teng.params,
                          max_seq_length=128, batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="quadratic"):
        tspec.SpeculativeDecoder(lin)
    with pytest.raises(ValueError, match="draft engine must use the KV-cache"):
        tspec.DraftSpeculativeDecoder(teng, lin)


# ----------------------------------------------------------- sampling mode


def test_speculative_accept_distribution():
    """The first emitted token is distributed as p_0; given draft[0]
    accepted, the second as p_1; draft[0] is accepted with probability
    p_0(draft[0]). 40 000 trials in one batched call."""
    k, v, temp = 3, 16, 0.8
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.normal(size=(k + 1, v)) * 2.0).astype(np.float32))
    draft = torch.tensor([5, 11, 2], dtype=torch.int32)
    n = 40_000
    a, tokens = speculative_accept(logits.expand(n, k + 1, v), draft.expand(n, k), temp,
                                   generator=torch.Generator().manual_seed(42))
    a, tokens = a.numpy(), tokens.numpy()
    p = np.exp(np.asarray(jax.nn.log_softmax(jnp.asarray(logits.numpy()) / temp, axis=-1)))
    np.testing.assert_allclose(np.exp(filtered_log_probs(logits, temp).numpy()), p, rtol=1e-5)
    emp0 = np.bincount(tokens[:, 0], minlength=v) / n
    np.testing.assert_allclose(emp0, p[0], atol=4.5 / np.sqrt(n))
    sel = a >= 1
    emp1 = np.bincount(tokens[sel, 1], minlength=v) / sel.sum()
    np.testing.assert_allclose(emp1, p[1], atol=4.5 / np.sqrt(sel.sum()))
    np.testing.assert_allclose(sel.mean(), p[0, 5], atol=4.5 / np.sqrt(n))
    # unbatched, the same rule: one trial's shapes
    a1, t1 = speculative_accept(logits, draft, temp, generator=torch.Generator().manual_seed(1))
    assert a1.shape == () and t1.shape == (k + 1,) and t1.dtype == torch.int32


def test_speculative_accept_top_k():
    """With top_k the emitted token lies in the verifier's top-k set, even
    when the drafts do not (they are then always rejected at position 0)."""
    k, v, top_k = 2, 32, 4
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(k + 1, v)).astype(np.float32))
    topsets = np.argsort(logits.numpy(), axis=-1)[:, -top_k:]
    draft = torch.tensor([np.setdiff1d(np.arange(v), topsets[i])[0] for i in range(k)],
                         dtype=torch.int32)
    a, tokens = speculative_accept(logits.expand(500, k + 1, v), draft.expand(500, k), 1.0,
                                   top_k, generator=torch.Generator().manual_seed(7))
    assert (a == 0).all()
    assert np.isin(tokens[:, 0].numpy(), topsets[0]).all()


def test_speculative_accept_logq_distribution():
    """The general rule: d_0 ~ q_0, then accept or resample, emits the first
    token distributed as p_0 for q != p, and accepts d_0 with probability
    sum_d min(p(d), q(d))."""
    k, v, temp = 2, 12, 1.0
    rng = np.random.default_rng(2)
    logits_p = torch.from_numpy((rng.normal(size=(k + 1, v)) * 1.5).astype(np.float32))
    logits_q = torch.from_numpy((rng.normal(size=(k, v)) * 1.5).astype(np.float32))
    logq = filtered_log_probs(logits_q, temp)
    p = np.exp(filtered_log_probs(logits_p, temp).numpy())
    q = np.exp(logq.numpy())
    n = 40_000
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((n, k, v), generator=gen)
    draft = torch.argmax(logq - torch.log(-torch.log(u + 1e-20) + 1e-20), -1).to(torch.int32)
    a, tokens = speculative_accept_logq(logits_p.expand(n, k + 1, v), draft,
                                        logq.expand(n, k, v), temp, generator=gen)
    emp = np.bincount(tokens[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(emp, p[0], atol=4.5 / np.sqrt(n))
    np.testing.assert_allclose((a.numpy() >= 1).mean(), np.sum(np.minimum(p[0], q[0])),
                               atol=4.5 / np.sqrt(n))


def test_speculative_sampling_generate():
    """temperature > 0: reproducible from a seeded generator, another seed
    gives another sequence, tokens in the vocabulary, the prompt kept."""
    _, teng = _engines("target")
    spec = tspec.SpeculativeDecoder(teng, k=4)
    prompt = torch.from_numpy(np.tile([3, 4, 5, 6], 4).astype(np.int32))

    def run(seed):
        return spec.generate(prompt, 64, temperature=0.7, top_k=20,
                             generator=torch.Generator().manual_seed(seed)).numpy()

    out1 = run(3)
    np.testing.assert_array_equal(out1, run(3))
    out3 = run(4)
    assert out1.shape[1] == 64 and (out1 >= 0).all() and (out1 < 96).all()
    assert out1.shape != out3.shape or not np.array_equal(out1, out3)
    np.testing.assert_array_equal(out1[0, :16], prompt.numpy())


def test_speculative_sampling_eos():
    _, teng = _engines("target")
    prompt = torch.arange(1, 17, dtype=torch.int32)
    spec = tspec.SpeculativeDecoder(teng, k=4)
    ref = spec.generate(prompt, 64, temperature=0.9,
                        generator=torch.Generator().manual_seed(11)).numpy()
    eos = int(ref[0, 16 + 2])
    got = spec.generate(prompt, 64, temperature=0.9, eos_id=eos,
                        generator=torch.Generator().manual_seed(11)).numpy()
    # the same generator, the same stream: it stops at that eos
    assert got.shape[1] <= ref.shape[1]
    assert got[0, -1] == eos
    assert int((got[0, 16:] == eos).sum()) == 1


# ------------------------------------------------------ the draft-model decoder


def test_draft_spec_greedy_parity():
    """With any draft model, temperature 0 gives the target's greedy decode,
    and the JAX decoder's verify and acceptance counts."""
    (jeng, teng), (jdeng, tdeng) = _engines("target"), _engines("draft")
    spec = tspec.DraftSpeculativeDecoder(teng, tdeng, k=4)
    jspec_ = jspec.DraftSpeculativeDecoder(jeng, jdeng, k=4)
    for seed in (0, 1):
        prompt = _prompt("random", seed)
        ref = _greedy(teng, prompt, 80)
        got = spec.generate(torch.from_numpy(prompt), 80).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(np.asarray(jspec_.generate(jnp.asarray(prompt), 80)), got)
        assert (spec.last_steps, spec.last_accepted) == \
            (jspec_.last_steps, jspec_.last_accepted)
        assert spec.last_steps <= 80 - 16


def test_draft_spec_self_draft_accepts_everything():
    """Draft == target: every draft is the target's argmax, so each verify
    decides k+1 tokens."""
    _, teng = _engines("target")
    spec = tspec.DraftSpeculativeDecoder(teng, teng, k=4)
    prompt = np.random.default_rng(3).integers(1, 96, (16,)).astype(np.int32)
    got = spec.generate(torch.from_numpy(prompt), 66).numpy()
    np.testing.assert_array_equal(got, _greedy(teng, prompt, 66))
    # 49 tokens to decide after the first: ceil(49 / 5) = 10 verify steps
    assert spec.last_steps <= 11
    assert spec.last_accepted >= spec.last_steps * 3


def test_draft_spec_sampling_runs():
    _, teng = _engines("target")
    _, tdeng = _engines("draft")
    spec = tspec.DraftSpeculativeDecoder(teng, tdeng, k=3)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(1, 96, (12,)).astype(np.int32))

    def run():
        return spec.generate(prompt, 60, temperature=0.8, top_k=30,
                             generator=torch.Generator().manual_seed(21)).numpy()

    o1 = run()
    np.testing.assert_array_equal(o1, run())
    assert o1.shape[1] == 60 and (o1 >= 0).all() and (o1 < 96).all()
    np.testing.assert_array_equal(o1[0, :12], prompt.numpy())
    assert 0 <= spec.last_accepted <= 3 * spec.last_steps


def test_draft_spec_guards():
    _, teng = _engines("target")
    _, tdeng = _engines("draft")
    spec = tspec.DraftSpeculativeDecoder(teng, tdeng, k=8)
    with pytest.raises(ValueError, match="headroom"):
        spec.generate(torch.tensor([1, 2, 3]), 128)
    with pytest.raises(ValueError, match=">= 2"):
        spec.generate(torch.tensor([1]), 32)
    bad_cfg = dict(block_size=64, vocab_size=50, padded_vocab_size=50, n_layer=1, n_head=2,
                   n_embd=32, rotary_percentage=1.0)
    from fastmax_tpu_torch.models import gpt

    bad = InferenceEngine(Config(**bad_cfg), gpt.init_params(Config(**bad_cfg), 0,
                                                             device="cpu"),
                          max_seq_length=64, batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tspec.DraftSpeculativeDecoder(teng, bad, k=4)
