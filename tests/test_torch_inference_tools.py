"""The port's inference command lines against the JAX package on the CPU:
``inference/generate.py`` (``main``, ``load_and_prepare``,
``apply_finetuned``), ``inference/chat.py`` (``prompt_config``,
``StreamingSession``, ``main``), ``server.main``, ``bench_serving.run`` and
``utils/profiling.py``.

One checkpoint directory is written by the JAX package (a tiny GQA LLaMA and
a BPE tokenizer trained here, as tests/test_inference_tools.py builds one)
and read by both packages. Greedy text (float32, temperature 0) is held
equal: ``generate.main``'s stdout, the chat REPL's, the streamed tokens.
Sampled text is not: the port draws its noise from a torch.Generator.
"""

import builtins
import json
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference import bench_serving as jbench
from fastmax_tpu.inference import chat as jchat
from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import lora as jlora
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from fastmax_tpu.training.finetune import _flatten_delta
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu_torch.inference import bench_serving, chat, generate, server
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models.tokenizer import Tokenizer
from fastmax_tpu_torch.utils import profiling
from fastmax_tpu_torch.utils.checkpoint import load_model_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(name="tools-tiny-gqa", block_size=128, n_layer=2, n_head=4, n_embd=64,
            n_query_groups=2, rotary_percentage=1.0, parallel_residual=False, bias=False,
            _norm_class="RMSNorm", _mlp_class="LLaMAMLP", intermediate_size=128)
BENCH = dict(name="bench-tiny", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2,
             n_head=4, n_embd=64, n_query_groups=2, intermediate_size=128,
             rotary_percentage=1.0, parallel_residual=False, bias=False,
             _norm_class="RMSNorm", _mlp_class="LLaMAMLP")
TEXT = "hello world this is a tiny tokenizer for the chat and generate tools"
GREEDY = dict(prompt="hello world", max_new_tokens=8, temperature=0.0, precision="float32")
# the 19 family names of tests/test_inference_tools.py's prompt_config test
FAMILIES = ("Llama-2-7b-chat-hf", "vicuna-7b-v1.5", "Mistral-7B-Instruct-v0.1",
            "TinyLlama-1.1B-Chat-v1.0", "phi-1_5", "phi-2", "unknown-model",
            "RedPajama-INCITE-Chat-3B-v1", "RedPajama-INCITE-Instruct-3B-v1",
            "falcon-7b-instruct", "Llama-2-7b-chat-hf-function-calling-v2", "Platypus2-7B",
            "Nous-Hermes-llama-2-7b", "stablecode-instruct-alpha-3b", "CodeLlama-7b-Instruct-hf",
            "FreeWilly2", "gemma-7b-it", "stablelm-tuned-alpha-3b", "stablelm-zephyr-3b")


def write_tokenizer(d: Path, texts=(TEXT,), vocab_size: int = 120) -> int:
    """A BPE tokenizer trained on ``texts``, eos "<eos>"; returns its size."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    tok = HFTok(BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(list(texts) * 20, BpeTrainer(special_tokens=["[UNK]", "<eos>"],
                                                         vocab_size=vocab_size))
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<eos>"}))
    return tok.get_vocab_size()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(directory, JAX config, JAX params): weights, lit_config.json and the
    tokenizer, written by the JAX package."""
    d = tmp_path_factory.mktemp("ckpt")
    vocab = write_tokenizer(d)
    cfg = JaxConfig(**{**TINY, "vocab_size": vocab, "padded_vocab_size": vocab})
    params = jgpt.init_params(cfg, jax.random.PRNGKey(0))
    jckpt.save_flat_checkpoint(jparams.params_to_flat(params, cfg), d)
    cfg.to_json(d / "lit_config.json")
    return d, cfg, params


@pytest.fixture(scope="module")
def finetuned(ckpt, tmp_path_factory):
    """{"lora": a LoRA delta file, "full": a full weights file}, by the JAX package."""
    d, cfg, params = ckpt
    out = tmp_path_factory.mktemp("finetuned")
    lp = jlora.add_lora_params(params, cfg, jlora.LoRAConfig(r=4, alpha=8, mlp=True),
                               jax.random.PRNGKey(1))
    lp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if "lora_B" in str(path[-1]) else x, lp)
    _, delta = jlora.split_lora_state(lp)
    jckpt.save_flat_checkpoint(_flatten_delta(delta), out / "lora.safetensors")
    moved = jax.tree.map(lambda x: x * 1.5, params)
    jckpt.save_flat_checkpoint(jparams.params_to_flat(moved, cfg), out / "full.safetensors")
    return {"lora": out / "lora.safetensors", "full": out / "full.safetensors"}


# ------------------------------------------------------------------ generate


GENERATE_CASES = {
    "two_samples": ({"num_samples": 2}, {}),
    "bnb.int8": ({"quantize": "bnb.int8"}, {}),
    # "auto" on a packed 4-bit tree: the reference's chip branch, which the port takes
    "bnb.nf4_auto": ({"quantize": "bnb.nf4", "weights_mode": "auto"},
                     {"weights_mode": "preload_int4"}),
    "lora": ({"method": "lora"}, {}),
    "full": ({"method": "full"}, {}),
    "int8_cache_prompt_style": ({"kv_cache_dtype": "int8", "prompt_style": "alpaca"}, {}),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_main_prints_the_jax_text(ckpt, finetuned, case, capsys):
    d = ckpt[0]
    kw, jax_only = GENERATE_CASES[case]
    if case in finetuned:
        kw = {**kw, "finetuned_path": finetuned[case]}
    jgenerate.main(checkpoint_dir=d, **{**GREEDY, **kw, **jax_only})
    want = capsys.readouterr().out
    flags = [f"--{k}={v}" for k, v in {**GREEDY, **kw, "checkpoint_dir": d}.items()]
    generate.cli(flags + ["--device", "cpu"])
    got = capsys.readouterr()
    assert got.out == want and got.out.count("hello world") == kw.get("num_samples", 1)
    assert got.err.count("tokens/sec") == kw.get("num_samples", 1)
    assert "Memory used" not in got.err  # the CPU reports no device memory


def test_load_and_prepare_merges_lora_like_jax(ckpt, finetuned):
    d = ckpt[0]
    _, want = jgenerate.load_and_prepare(d, finetuned_path=finetuned["lora"],
                                         precision="float32")
    _, got = generate.load_and_prepare(d, finetuned_path=finetuned["lora"],
                                       precision="float32", device="cpu")
    for name in ("attn", "proj"):
        np.testing.assert_array_equal(got["blocks"]["attn"][name]["kernel"].numpy(),
                                      np.asarray(want["blocks"]["attn"][name]["kernel"]))
    for name in ("fc_1", "fc_2", "proj"):
        np.testing.assert_array_equal(got["blocks"]["mlp"][name]["kernel"].numpy(),
                                      np.asarray(want["blocks"]["mlp"][name]["kernel"]))
        assert set(got["blocks"]["mlp"][name]) == {"kernel"}


# ------------------------------------------------------------------ chat


def stream_tokens(stream) -> list:
    return [int(t) for chunk in stream for t in np.asarray(chunk).reshape(-1)]


def test_streaming_session_matches_jax_and_the_engine(ckpt):
    d = ckpt[0]
    jcfg, jp = jckpt.load_model_params(d)
    cfg, tp = load_model_params(d, device="cpu")
    tok = Tokenizer(d)
    enc = tok.encode("hello world this")
    stops = ([tok.eos_id],)
    want = stream_tokens(jchat.StreamingSession(jcfg, jp, 64).generate_stream(
        enc, len(enc) + 12, temperature=0.0, stop_tokens=stops, key=jax.random.PRNGKey(0)))
    got = stream_tokens(chat.StreamingSession(cfg, tp, 64).generate_stream(
        enc, len(enc) + 12, temperature=0.0, stop_tokens=stops))
    assert got == want and 0 < len(got) <= 12
    eng = InferenceEngine(cfg, tp, max_seq_length=64, device="cpu")
    ref = eng.generate(torch.from_numpy(enc), len(enc) + 12, eos_id=tok.eos_id)
    assert got == ref[0, len(enc):].tolist()[: len(got)]


def test_stop_sequence_cuts_the_stream_mid_stream(ckpt):
    d = ckpt[0]
    cfg, tp = load_model_params(d, device="cpu")
    session = chat.StreamingSession(cfg, tp, 64)
    enc = Tokenizer(d).encode("hello world")
    free = stream_tokens(session.generate_stream(enc, len(enc) + 8, temperature=0.0))
    assert len(free) == 8
    pair = free[2:4]
    cut = stream_tokens(session.generate_stream(enc, len(enc) + 8, temperature=0.0,
                                                stop_tokens=(pair,)))
    first = next(i for i in range(len(free) - 1) if free[i:i + 2] == pair)
    assert cut == free[:first]
    jcfg, jp = jckpt.load_model_params(d)
    jcut = stream_tokens(jchat.StreamingSession(jcfg, jp, 64).generate_stream(
        enc, len(enc) + 8, temperature=0.0, stop_tokens=(pair,), key=jax.random.PRNGKey(0)))
    assert cut == jcut


def test_sampled_stream_follows_its_generator(ckpt):
    d = ckpt[0]
    cfg, tp = load_model_params(d, device="cpu")
    session = chat.StreamingSession(cfg, tp, 64)
    enc = Tokenizer(d).encode("hello world")

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return stream_tokens(session.generate_stream(enc, len(enc) + 16, temperature=1.0,
                                                     top_k=20, generator=gen))

    assert draw(3) == draw(3) and len(draw(3)) == 16


@pytest.mark.parametrize("name", FAMILIES)
def test_prompt_config_matches_jax(ckpt, name):
    d = ckpt[0]
    want = jchat.prompt_config(name, JaxTokenizer(d))
    got = chat.prompt_config(name, Tokenizer(d))
    assert got[0] == want[0] and "{prompt}" in got[0]
    assert [list(s) for s in got[1]] == [list(s) for s in want[1]]


def test_chat_main_with_input_patched(ckpt, monkeypatch, capsys):
    d = ckpt[0]
    # the reference's decode_stream binds sys.stdout when it is defined: send its
    # reply to the stdout that capsys reads, as the port's does
    real = jchat.decode_stream
    monkeypatch.setattr(jchat, "decode_stream",
                        lambda tok, stream, out=None: real(tok, stream, sys.stdout))

    def run(main, **kw):
        answers = iter(["hello world", "this is a", ""])
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
        main(checkpoint_dir=d, precision="float32", max_new_tokens=6, temperature=0.0, **kw)
        return capsys.readouterr()

    want = run(jchat.main)
    got = run(chat.main, device="cpu")
    assert got.out == want.out and got.out.count(">> Reply: ") == 2
    assert len(got.out.split(">> Reply: ")[1].strip()) > 0  # the reply itself is compared
    assert got.err.count("tokens/sec") == 2


# ------------------------------------------------------------------ server


def test_server_main_answers_a_request_then_stops(ckpt, monkeypatch, capsys):
    d, jcfg, jp = ckpt
    made = []
    real_server, real_sleep = server.Server, time.sleep

    class Recording(real_server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    answers = []

    def sleep(s):
        if s != 3600:  # the scheduler thread's idle wait
            return real_sleep(s)
        body = json.dumps({"prompt": "hello world this", "max_new_tokens": 6}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{made[0].port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answers.append(json.loads(r.read()))
        raise KeyboardInterrupt

    monkeypatch.setattr(server, "Server", Recording)
    monkeypatch.setattr(time, "sleep", sleep)
    server.cli(["--checkpoint_dir", str(d), "--host", "127.0.0.1", "--port", "0",
                "--n_slots", "2", "--precision", "float32", "--device", "cpu"])
    assert f"serving {jcfg.name} on http://127.0.0.1:" in capsys.readouterr().out
    (answer,) = answers
    enc = JaxTokenizer(d).encode("hello world this")
    ref = np.asarray(JaxEngine(jcfg, jp, max_seq_length=64).generate(
        jnp.asarray(enc), len(enc) + 6, temperature=0.0, eos_id=JaxTokenizer(d).eos_id))
    want = ref[0, len(enc):].tolist()
    assert answer["tokens"] == want and answer["prompt_tokens"] == len(enc)
    assert not made[0].scheduler._thread.is_alive()  # stopped on the interrupt


# ------------------------------------------------------------------ bench_serving


@pytest.fixture
def bench_registries(monkeypatch):
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg[BENCH["name"]] = dict(BENCH)
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)


@pytest.mark.parametrize("load", ["closed", "open"])
def test_bench_serving_prints_the_jax_keys(load, bench_registries, capsys):
    kw = (dict(n_slots=2, n_requests=4, prompt_len=8, max_new_tokens=6) if load == "closed" else
          dict(n_slots=2, n_requests=3, prompt_len=8, max_new_tokens=4, arrival_rate=50.0,
               decode_quantum=2))
    want = jbench.run(model_name=BENCH["name"], precision="float32", **kw)
    capsys.readouterr()
    flags = [f"--{k}={v}" for k, v in kw.items()]
    got = bench_serving.main(["--model_name", BENCH["name"], "--precision", "float32",
                              "--device", "cpu"] + flags)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == got and set(got) == set(want)
    for k in ("metric", "model", "n_slots", "decode_quantum", "n_requests", "generated_tokens"):
        assert got[k] == want[k], k
    assert got["generated_tokens"] == kw["n_requests"] * kw["max_new_tokens"]
    assert got["ttft_p50_ms"] <= got["ttft_p95_ms"] and got["latency_p50_s"] <= got[
        "latency_p95_s"]


def test_bench_serving_from_a_checkpoint_dir(ckpt, capsys):
    got = bench_serving.run(checkpoint_dir=ckpt[0], precision="float32", quantize="bnb.nf4",
                            n_slots=2, n_requests=2, prompt_len=6, max_new_tokens=3,
                            device="cpu")
    assert got["model"] == TINY["name"] and got["generated_tokens"] == 6


# ------------------------------------------------------------------ profiling


def test_profiling_on_the_cpu(tmp_path, monkeypatch):
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("matmul-region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "matmul-region" in (tmp_path / "trace" / "trace.json").read_text()
    assert profiling.device_memory_stats("cpu") == {
        "bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0, "source": "none"}

    mon = profiling.ThroughputMonitor(window_size=3, flops_per_token=1e9)
    assert mon.compute() == {}
    for n in (100, 100, 100, 100):
        mon.update(n)
        time.sleep(0.01)
    out = mon.compute()
    assert set(out) <= {"tokens_per_sec", "mfu"} and 0 < out["tokens_per_sec"] < 200 / 0.019

    for name, rate in (("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
                       ("NVIDIA H100 NVL", 3.9e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert profiling.hbm_bw_peak() == rate
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "TPU v5 lite")
    with pytest.raises(ValueError, match="no data-sheet memory rate"):
        profiling.hbm_bw_peak()

    from fastmax_tpu_torch.kernels import build

    default = profiling.enable_compile_cache()
    assert default == build.BUILD_DIR and default.name == "_build"
    monkeypatch.setattr(build, "BUILD_DIR", default)
    assert profiling.enable_compile_cache(tmp_path / "kb") == tmp_path / "kb" == build.BUILD_DIR
