"""Speculative decoding on the port's serving path against the JAX package on
the CPU: the batcher's ``speculative_k`` (fastmax_tpu_torch/inference/
continuous.py), the counterparts of tests/test_continuous.py's speculative
cases, with the prefix cache and with chunked prefill; the host drafts
(``_draft_np``) on seeded histories; the three guards; and the command lines:
``generate --speculative_k`` with and without ``--draft_checkpoint_dir``,
``bench_serving``'s ``spec_acceptance`` and the server with
``--speculative_k`` on 127.0.0.1.

The batcher's weights are the JAX package's float32 init of
tests/test_torch_continuous.py's tiny Llama (the reference's own speculative
batcher tests run dense float32 weights; the int4 route at m = slots (k+1)
is held on the card, phase 17); greedy tokens must equal the JAX speculative
batcher's and the port's own non-speculative batcher's, and the acceptance
counters the JAX batcher's."""

import json
import time
import urllib.request

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference import bench_serving as jbench
from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.inference.continuous import ContinuousBatcher as JaxBatcher
from fastmax_tpu.inference.continuous import Request as JaxRequest
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu_torch.inference import bench_serving, generate, server
from fastmax_tpu_torch.inference.continuous import ContinuousBatcher, Request
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from tests.test_torch_continuous import TINY
from tests.test_torch_inference_tools import TINY as CKPT_TINY
from tests.test_torch_inference_tools import write_tokenizer

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _params():
    tree = jgpt.init_params(JaxConfig(**TINY), jax.random.PRNGKey(0), jnp.float32)
    return tree, from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


def _make(kind, int8=False, **kw):
    jp, tp = _params()
    kw.setdefault("max_seq_length", TINY["block_size"])
    if kind == "jax":
        return JaxBatcher(JaxConfig(**TINY), jp, cache_dtype=jnp.int8 if int8 else None, **kw)
    return ContinuousBatcher(Config(**TINY), tp, cache_dtype=torch.int8 if int8 else None,
                             device="cpu", **kw)


REP = np.tile([3, 4, 5, 6], 5).astype(np.int32)  # repetitive: prompt lookup lands


# Scenarios of tests/test_continuous.py's speculative cases: each drives one batcher and
# returns what the batchers must agree on.

def joining(b):
    """Repetitive and random prompts on two slots, a third joining mid-flight."""
    p2, p3 = np.arange(20, 37, dtype=np.int32), np.asarray([5, 50, 7, 9], np.int32)
    reqs = [b.submit(p, 14, return_request=True) for p in (REP, p2)]
    for _ in range(2):
        b.step()
    reqs.append(b.submit(p3, 14, return_request=True))
    b.run_to_completion()
    return [r.generated for r in reqs]


def telemetry(b):
    rid = b.submit(REP, 16)
    return [b.run_to_completion()[rid]]


def eos(b):
    """eos = the 5th greedy token: the request stops there; the freed slot
    serves a follow-up."""
    prompt = np.arange(1, 11, dtype=np.int32)
    rid = b.submit(prompt, 20, eos_id=_eos())
    first = b.run_to_completion()[rid]
    rid2 = b.submit(prompt, 3)
    return [first, b.run_to_completion()[rid2]]


def topk1(b):
    """temperature > 0 with top_k 1 takes the sampled verify (filter, test,
    residual resample) and must give the greedy tokens: the filtered
    distribution is a point mass."""
    r1 = b.submit(REP, 12, temperature=1.3, top_k=1)
    r2 = b.submit(np.arange(20, 31, dtype=np.int32), 12, temperature=0.7, top_k=1)
    res = b.run_to_completion()
    return [res[r1], res[r2]]


def topk1_greedy(b):
    """topk1's prompts, greedy."""
    r1 = b.submit(REP, 12)
    r2 = b.submit(np.arange(20, 31, dtype=np.int32), 12)
    res = b.run_to_completion()
    return [res[r1], res[r2]]


def prefix(b):
    """A registered repetitive system prompt shared by two requests."""
    system = np.tile([3, 4, 5, 6], 8).astype(np.int32)
    b.register_prefix(system)
    r1 = b.submit(np.concatenate([system, [9, 10]]).astype(np.int32), 12)
    r2 = b.submit(np.concatenate([system, [11]]).astype(np.int32), 12)
    res = b.run_to_completion()
    return [res[r1], res[r2], b.prefix_cache_hits]


def chunked(b):
    """A prompt longer than the chunk, and one decoding while it prefills."""
    r0 = b.submit(np.asarray([3, 4, 5], np.int32), 20)
    b.step()
    r1 = b.submit(np.arange(1, 30, dtype=np.int32), 10)
    res = b.run_to_completion()
    return [res[r0], res[r1]]


_EOS = []


def _eos() -> int:
    """The 5th greedy token of eos()'s prompt (JAX batcher, no speculation)."""
    if not _EOS:
        b = _make("jax", n_slots=1)
        rid = b.submit(np.arange(1, 11, dtype=np.int32), 20)
        _EOS.append(int(b.run_to_completion()[rid][4]))
    return _EOS[0]


CASES = {
    "joining": (joining, dict(n_slots=2, speculative_k=4), joining),
    "telemetry": (telemetry, dict(n_slots=1, speculative_k=4), telemetry),
    "eos": (eos, dict(n_slots=1, speculative_k=6), eos),
    "topk1": (topk1, dict(n_slots=2, speculative_k=4), topk1_greedy),
    "int8_cache_k8": (joining, dict(n_slots=2, speculative_k=8, int8=True), joining),
    "prefix_cache": (prefix, dict(n_slots=2, prefix_cache_size=2, speculative_k=4), prefix),
    "prefill_chunk": (chunked, dict(n_slots=2, prefill_chunk=8, speculative_k=4), chunked),
    "prefix_chunk_int8": (prefix, dict(n_slots=2, prefix_cache_size=2, prefill_chunk=8,
                                       speculative_k=4, int8=True), prefix),
}


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_batcher_matches_the_reference(case):
    """Greedy tokens equal the JAX speculative batcher's and the port's own
    batcher's without speculation; the acceptance counters the JAX batcher's."""
    scenario, kw, plain_scenario = CASES[case]
    jb = _make("jax", **kw)
    want = scenario(jb)
    tb = _make("torch", **kw)
    got = scenario(tb)
    assert got == want
    assert (tb.spec_accepted, tb.spec_drafted) == (jb.spec_accepted, jb.spec_drafted)
    assert 0 < tb.spec_drafted and 0 <= tb.spec_accepted <= tb.spec_drafted
    no_spec = {k: v for k, v in kw.items() if k != "speculative_k"}
    assert got == plain_scenario(_make("torch", **no_spec))
    if case == "telemetry":
        assert tb.spec_accepted > tb.spec_drafted // 2  # the repetitive prompt's drafts land


def test_speculative_hot_sampling_runs():
    """Unrestricted hot sampling under batched speculation: the token counts,
    in the vocabulary, reproducible from a seeded generator."""
    def run(seed):
        b = _make("torch", n_slots=2, speculative_k=4,
                  generator=torch.Generator().manual_seed(seed))
        r1 = b.submit(REP, 20, temperature=1.0)
        r2 = b.submit(np.arange(1, 9, dtype=np.int32), 20, temperature=0.8, top_k=20)
        res = b.run_to_completion()
        return [res[r1], res[r2]], b.spec_drafted

    (toks, drafted), (again, _) = run(5), run(5)
    assert toks == again and drafted > 0
    for t in toks:
        assert len(t) == 20 and all(0 <= x < TINY["padded_vocab_size"] for x in t)


def test_host_drafts_match_the_reference():
    """``_draft_np`` against the JAX batcher's on seeded histories: short
    matches padded with the last token, no match, histories under 4 tokens."""
    rng = np.random.default_rng(0)
    for trial in range(200):
        n_prompt = int(rng.integers(1, 12))
        prompt = rng.integers(0, 3 if trial % 2 else 6, n_prompt).astype(np.int32)
        gen = rng.integers(0, 3 if trial % 2 else 6, int(rng.integers(1, 10))).tolist()
        k = int(rng.integers(1, 9))
        want = JaxBatcher._draft_np(None, JaxRequest(0, prompt, 8, generated=list(gen)), k)
        got = ContinuousBatcher._draft_np(None, Request(0, prompt, 8, generated=list(gen)), k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.shape == (k,)


def test_speculative_guards():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _make("torch", n_slots=1, decode_quantum=4, speculative_k=4)
    with pytest.raises(ValueError, match="prefill_chunk must be >="):
        _make("torch", n_slots=1, prefill_chunk=4, speculative_k=4)
    _make("torch", n_slots=1, prefill_chunk=5, speculative_k=4)  # k+1 fits
    _, tp = _params()
    with pytest.raises(ValueError, match="quadratic"):
        ContinuousBatcher(Config(**TINY, attn_alg="linearmax"), tp, speculative_k=4,
                          device="cpu")
    # near the end of the cache a request retires before a verify would write past it,
    # as the reference's does (headroom k+1)
    got = []
    for kind in ("jax", "torch"):
        b = _make(kind, n_slots=1, speculative_k=3)
        assert b._headroom == 4
        rid = b.submit(np.arange(1, 100, dtype=np.int32), 100)
        got.append(b.run_to_completion()[rid])
        assert b.positions[0] + b._headroom >= TINY["block_size"] > b.positions[0]
    assert got[0] == got[1] and len(got[1]) < 100


# ------------------------------------------------------------------ command lines


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A target and a draft checkpoint of one vocabulary (the draft a 1-layer
    model), each with the tokenizer, written by the JAX package."""
    dirs = {}
    for name, n_layer, seed in (("target", 2, 0), ("draft", 1, 3)):
        d = tmp_path_factory.mktemp(name)
        vocab = write_tokenizer(d)
        cfg = JaxConfig(**{**CKPT_TINY, "vocab_size": vocab, "padded_vocab_size": vocab,
                           "n_layer": n_layer})
        params = jgpt.init_params(cfg, jax.random.PRNGKey(seed))
        jckpt.save_flat_checkpoint(jparams.params_to_flat(params, cfg), d)
        cfg.to_json(d / "lit_config.json")
        dirs[name] = (d, cfg, params)
    return dirs


GREEDY = dict(prompt="hello world this is", max_new_tokens=12, temperature=0.0,
              precision="float32")


@pytest.mark.parametrize("draft", [False, True])
def test_generate_speculative_prints_the_jax_text(ckpts, draft, capsys):
    """``generate --speculative_k`` (prompt lookup, and a draft model) prints
    the JAX command's greedy text, which is the plain decode's."""
    d = ckpts["target"][0]
    kw = {"speculative_k": 3}
    if draft:
        kw["draft_checkpoint_dir"] = ckpts["draft"][0]
    jgenerate.main(checkpoint_dir=d, **GREEDY, **kw)
    want = capsys.readouterr().out
    generate.cli([f"--{k}={v}" for k, v in {**GREEDY, **kw, "checkpoint_dir": d}.items()]
                 + ["--device", "cpu"])
    got = capsys.readouterr()
    assert got.out == want and "tokens/sec" in got.err
    generate.main(checkpoint_dir=d, **GREEDY, device="cpu")
    assert capsys.readouterr().out == want


def test_bench_serving_spec_acceptance(ckpts, capsys):
    """The JSON line carries ``spec_acceptance``: the JAX command's figure on
    the same checkpoint (the same greedy tokens, the same drafts)."""
    kw = dict(checkpoint_dir=ckpts["target"][0], precision="float32", n_slots=2,
              n_requests=3, prompt_len=8, max_new_tokens=10, speculative_k=3)
    want = jbench.run(**kw)
    capsys.readouterr()
    got = bench_serving.main([f"--{k}={v}" for k, v in kw.items()] + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want) and "spec_acceptance" in got
    assert got["spec_acceptance"] == want["spec_acceptance"]
    assert got["generated_tokens"] == want["generated_tokens"] == 30
    plain = bench_serving.run(**{**kw, "speculative_k": 0}, device="cpu")
    assert "spec_acceptance" not in plain


def test_server_speculative_answers_a_request(ckpts, monkeypatch, capsys):
    """The server's main with ``--speculative_k`` answers over a real socket
    with the JAX engine's greedy tokens."""
    d, jcfg, jp = ckpts["target"]
    made, answers = [], []
    real_server, real_sleep = server.Server, time.sleep

    class Recording(real_server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def sleep(s):
        if s != 3600:  # the scheduler thread's idle wait
            return real_sleep(s)
        for prompt in ("hello world this", "this is a tiny tokenizer"):
            body = json.dumps({"prompt": prompt, "max_new_tokens": 9}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{made[0].port}/v1/generate",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append((prompt, json.loads(r.read())))
        raise KeyboardInterrupt

    monkeypatch.setattr(server, "Server", Recording)
    monkeypatch.setattr(time, "sleep", sleep)
    server.cli(["--checkpoint_dir", str(d), "--host", "127.0.0.1", "--port", "0",
                "--n_slots", "2", "--precision", "float32", "--speculative_k", "3",
                "--device", "cpu"])
    assert f"serving {jcfg.name} on http://127.0.0.1:" in capsys.readouterr().out
    tok = JaxTokenizer(d)
    for prompt, answer in answers:
        enc = tok.encode(prompt)
        ref = np.asarray(JaxEngine(jcfg, jp, max_seq_length=64).generate(
            jnp.asarray(enc), len(enc) + 9, temperature=0.0, eos_id=tok.eos_id))
        assert answer["tokens"] == ref[0, len(enc):].tolist()
    batcher = made[0].scheduler.batcher
    assert batcher.speculative_k == 3 and batcher.spec_drafted > 0
    assert not made[0].scheduler._thread.is_alive()
