"""The port's serving path with a linear ``attn_alg`` against the JAX package
on the CPU, float32: ``InferenceEngine.generate`` (dense and rank-1 int4
weights) and ``ContinuousBatcher``'s linear slots, each against the JAX one
and the batcher against the port's engine, the batcher's refusals with the
reference's messages, and the command lines that reach them: ``generate``,
``chat``, ``bench_serving`` and the eval harness's ``greedy_until`` (its
``generate_until``), and the server's system prompt refused.

The models here rotate the whole head (``rotary_percentage`` 1.0). At partial
RoPE the JAX package's compiled decode step gives wrong values on the CPU
(see ``tests/test_torch_linear_cache.py``, which holds the port's partial
RoPE decode against the same JAX code run eagerly); over the whole head it
does not, and the compiled JAX engines, batcher and mains are the reference.
Greedy divergences are faults unless the port's top-2 margin there is a
near-tie (ROADMAP queue C, "Near-ties").
"""

import builtins
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.eval import harness as jharness
from fastmax_tpu.inference import bench_serving as jbench
from fastmax_tpu.inference import chat as jchat
from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.inference.continuous import ContinuousBatcher as JaxBatcher
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu_torch.eval import harness
from fastmax_tpu_torch.inference import bench_serving, chat, generate, server
from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.tokenizer import Tokenizer
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.ops import fastmax as tfm
from fastmax_tpu_torch.utils.checkpoint import load_model_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)

NEAR_TIE = 1e-4
# tests/test_quant_pallas.py's small LLaMA with grouped heads, RoPE over the whole head
LIN = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
           n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
           _mlp_class="LLaMAMLP", bias=False, rotary_percentage=1.0)


@functools.lru_cache(maxsize=None)
def _params(int4: bool = False):
    dense = jgpt.init_params(JaxConfig(**LIN), jax.random.PRNGKey(0), jnp.float32)
    tree = (JaxEngine.prepare_params(jquant.quantize_model(dense, "bnb.nf4"), "preload_int4")
            if int4 else dense)
    return tree, from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


def _cfgs(alg):
    return JaxConfig(**LIN, attn_alg=alg), Config(**LIN, attn_alg=alg)


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(1, 128, (n,)).astype(np.int32)


def _margins(engine, seq: np.ndarray, n_prompt: int) -> np.ndarray:
    """Top-2 logit margin of the port at each generated position of ``seq``."""
    cache = engine.new_cache()
    with torch.inference_mode():
        logits, cache = engine._forward(torch.from_numpy(seq[:, :n_prompt]), cache, 0,
                                        is_prefill=True)
        rows = [logits[0, -1]]
        for pos in range(n_prompt, seq.shape[1] - 1):
            logits, cache = engine._forward(torch.from_numpy(seq[:, pos:pos + 1]), cache, pos)
            rows.append(logits[0, -1])
    top2 = torch.topk(torch.stack(rows).float(), 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def assert_same_tokens(engine, got, ref, n_prompt):
    diff = np.nonzero(got[0, n_prompt:] != ref[0, n_prompt:])[0]
    if diff.size:
        i = int(diff[0])
        margin = _margins(engine, ref, n_prompt)[i]
        kind = "a near-tie" if margin < NEAR_TIE else "not a near-tie: a fault"
        pytest.fail(f"tokens diverge at generated step {i}: port top-2 margin {margin:.2e} "
                    f"({kind})")


# ------------------------------------------------------------------ engine and batcher


@pytest.mark.parametrize("alg,int4", [("fastmax", False), ("fastmax_cuda", True),
                                      ("linearmax", True), ("performer", False)],
                         ids=["fastmax-dense", "fastmax_cuda-int4", "linearmax-int4",
                              "performer-dense"])
def test_engine_greedy_tokens_match_jax(alg, int4):
    jc, tc = _cfgs(alg)
    jp, tp = _params(int4)
    prompt, n_prompt, total = _tokens(11, 9), 9, 25
    mode = {"weights_mode": "quantized"} if int4 else {}
    ref = np.asarray(JaxEngine(jc, jp, max_seq_length=64, **mode).generate(
        jnp.asarray(prompt), total, temperature=0.0, key=jax.random.PRNGKey(0)))
    eng = InferenceEngine(tc, tp, max_seq_length=64, device="cpu", **mode)
    names = set(tfm.STATE_NAMES) | ({"q_div", "k_div"} if alg == "linearmax" else set())
    assert set(eng.new_cache()) == names
    got = eng.generate(torch.from_numpy(prompt), total).numpy()
    assert got.shape == ref.shape == (1, total)
    assert_same_tokens(eng, got, ref, n_prompt)
    # a one-token prompt prefills too
    one = eng.generate(torch.from_numpy(prompt[:1]), 4).numpy()
    assert one.shape == (1, 4) and one[0, 0] == prompt[0]


PROMPTS = [np.arange(1, 11, dtype=np.int32), np.arange(20, 31, dtype=np.int32), _tokens(4, 7)]


def _drive(b):
    """Three requests on two slots (the third waits for a free slot), 6 new
    tokens each; prompts of 10, 11 and 7 tokens inside one bucket."""
    rids = [b.submit(p, 6, temperature=0.0) for p in PROMPTS]
    res = b.run_to_completion()
    return [res[r] for r in rids]


@pytest.mark.parametrize("alg", ["fastmax", "linearmax", "performer"])
def test_batcher_linear_slots_match_the_engine(alg):
    """Each request's tokens equal its solo engine run, one token a step and
    with a decode quantum of 4; linear slots never take the batched wave."""
    _, tc = _cfgs(alg)
    _, tp = _params()
    eng = InferenceEngine(tc, tp, max_seq_length=64, device="cpu")
    solo = [eng.generate(torch.from_numpy(p), len(p) + 6)[0, len(p):].tolist() for p in PROMPTS]
    for quantum in (1, 4):
        b = ContinuousBatcher(tc, tp, n_slots=2, max_seq_length=64, decode_quantum=quantum,
                              prefill_bucket=16, device="cpu")
        assert _drive(b) == solo and b.batched_admissions == 0


def test_batcher_linear_slots_match_jax():
    """tests/test_continuous.py's linear-slot test (fastmax), with the third
    request admitted into a freed slot whose state held another's."""
    jc, tc = _cfgs("fastmax")
    jp, tp = _params()
    want = _drive(JaxBatcher(jc, jp, n_slots=2, max_seq_length=64))
    got = _drive(ContinuousBatcher(tc, tp, n_slots=2, max_seq_length=64, device="cpu"))
    assert got == want


REFUSALS = {"speculative_k": {"speculative_k": 4}, "prefix_cache": {"prefix_cache_size": 2},
            "prefill_chunk": {"prefill_chunk": 8}}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_linear_slots_refuse_like_the_reference(case):
    """tests/test_continuous.py's three refusals, with the reference's messages."""
    jc, tc = _cfgs({"speculative_k": "fastmax", "prefix_cache": "performer",
                    "prefill_chunk": "linearmax"}[case])
    jp, tp = _params()
    with pytest.raises(ValueError) as want:
        JaxBatcher(jc, jp, n_slots=1, **REFUSALS[case])
    with pytest.raises(ValueError) as got:
        ContinuousBatcher(tc, tp, n_slots=1, device="cpu", **REFUSALS[case])
    assert str(got.value) == str(want.value) and "quadratic" in str(got.value)
# ------------------------------------------------------------------ the command lines

TOOLS = dict(name="linear-tools-tiny", block_size=128, n_layer=2, n_head=4, n_embd=64,
             n_query_groups=2, rotary_percentage=1.0, parallel_residual=False, bias=False,
             _norm_class="RMSNorm", _mlp_class="LLaMAMLP", intermediate_size=128)
TEXT = "hello world this is a tiny tokenizer for the chat and generate tools"
CLI_ALGS = ("fastmax", "performer")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint directory written by the JAX package, with a BPE tokenizer."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    d = tmp_path_factory.mktemp("linear_ckpt")
    tok = HFTok(BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator([TEXT] * 20, BpeTrainer(special_tokens=["[UNK]", "<eos>"],
                                                    vocab_size=120))
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<eos>"}))
    vocab = tok.get_vocab_size()
    cfg = JaxConfig(**{**TOOLS, "vocab_size": vocab, "padded_vocab_size": vocab})
    params = jgpt.init_params(cfg, jax.random.PRNGKey(0))
    jckpt.save_flat_checkpoint(jparams.params_to_flat(params, cfg), d)
    cfg.to_json(d / "lit_config.json")
    return d


@pytest.mark.parametrize("alg", CLI_ALGS)
def test_generate_main_prints_the_jax_text(ckpt, alg, capsys):
    kw = dict(prompt="hello world", max_new_tokens=8, temperature=0.0, precision="float32",
              attn_alg=alg)
    jgenerate.main(checkpoint_dir=ckpt, **kw)
    want = capsys.readouterr().out
    generate.cli([f"--{k}={v}" for k, v in {**kw, "checkpoint_dir": ckpt}.items()]
                 + ["--device", "cpu"])
    got = capsys.readouterr()
    assert got.out == want and got.out.count("hello world") == 1
    assert f"attn_alg={alg}" in got.err


def stream_tokens(stream) -> list:
    return [int(t) for chunk in stream for t in np.asarray(chunk).reshape(-1)]


@pytest.mark.parametrize("alg", CLI_ALGS)
def test_chat_stream_and_main_match_jax(ckpt, alg, monkeypatch, capsys):
    """The chat session reads a dense KV cache, as the reference's does."""
    jcfg, jp = jckpt.load_model_params(ckpt)
    jcfg.attn_alg = alg
    cfg, tp = load_model_params(ckpt, device="cpu")
    cfg.attn_alg = alg
    enc = Tokenizer(ckpt).encode("hello world this")
    want = stream_tokens(jchat.StreamingSession(jcfg, jp, 64).generate_stream(
        enc, len(enc) + 10, temperature=0.0, key=jax.random.PRNGKey(0)))
    got = stream_tokens(chat.StreamingSession(cfg, tp, 64).generate_stream(
        enc, len(enc) + 10, temperature=0.0))
    assert got == want and len(got) == 10
    real = jchat.decode_stream
    monkeypatch.setattr(jchat, "decode_stream",
                        lambda tok, stream, out=None: real(tok, stream, sys.stdout))

    def run(main, **kw):
        answers = iter(["hello world", ""])
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
        main(checkpoint_dir=ckpt, precision="float32", max_new_tokens=6, temperature=0.0,
             attn_alg=alg, **kw)
        return capsys.readouterr().out

    assert run(chat.main, device="cpu") == run(jchat.main)


@pytest.mark.parametrize("alg", CLI_ALGS)
def test_bench_serving_main_matches_jax(ckpt, alg, capsys):
    kw = dict(n_slots=2, n_requests=3, prompt_len=8, max_new_tokens=5, precision="float32",
              attn_alg=alg)
    want = jbench.run(checkpoint_dir=ckpt, **kw)
    capsys.readouterr()
    got = bench_serving.main(["--checkpoint_dir", str(ckpt), "--device", "cpu"]
                             + [f"--{k}={v}" for k, v in kw.items()])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(got) == set(want)
    for k in ("metric", "model", "n_slots", "n_requests", "generated_tokens"):
        assert got[k] == want[k], k
    assert got["generated_tokens"] == 15


@pytest.mark.parametrize("alg", CLI_ALGS)
def test_generate_until_matches_jax(ckpt, alg):
    jcfg, jp = jckpt.load_model_params(ckpt)
    jcfg.attn_alg = alg
    cfg, tp = load_model_params(ckpt, device="cpu")
    cfg.attn_alg = alg
    jlm = jharness.FastmaxLM(jcfg, jp, JaxTokenizer(ckpt), max_seq_length=64)
    tlm = harness.FastmaxLM(cfg, tp, Tokenizer(ckpt), max_seq_length=64)
    for stop in ((), ("is",)):
        assert tlm.greedy_until("hello world", 8, stop) == jlm.greedy_until("hello world", 8, stop)
    assert isinstance(tlm._engine().new_cache()["s_kv"], torch.Tensor)


def test_server_system_prompt_needs_the_prefix_cache(ckpt):
    """A system prompt rides the prefix cache, which a linear arm refuses."""
    with pytest.raises(ValueError, match="prefix caching requires"):
        server.main(checkpoint_dir=ckpt, attn_alg="performer", precision="float32",
                    prefix_cache_size=2, system_prompt="hello world", device="cpu")
