"""The port's HTTP front end (fastmax_tpu_torch/inference/server.py) over a
real socket on a tiny model on the CPU: JSON generate and SSE streaming give
the port engine's greedy tokens and text, health, eos, concurrent clients
on fewer slots, and 400 on a bad body. The weights are the JAX package's
rank-1 int4 serving tree; the greedy tokens are also held to the JAX
engine's."""

import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.inference.server import Server
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(name="srv-tiny", block_size=128, vocab_size=128, padded_vocab_size=128, n_layer=2,
            n_head=4, n_embd=128, n_query_groups=2, intermediate_size=256,
            _norm_class="RMSNorm", _mlp_class="LLaMAMLP", bias=False, parallel_residual=False)


class FakeTokenizer:
    """Maps token id <-> 'tNN ' text so decode deltas are deterministic."""

    eos_id = None

    def encode(self, text):
        return [int(t[1:]) for t in text.split()]

    def decode(self, ids):
        return " ".join(f"t{int(i)}" for i in np.asarray(ids).reshape(-1))


@functools.lru_cache(maxsize=None)
def _params():
    dense = jgpt.init_params(JaxConfig(**TINY), jax.random.PRNGKey(0), jnp.float32)
    tree = JaxEngine.prepare_params(jquant.quantize_model(dense, "bnb.nf4"), "preload_int4")
    return tree, from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def served():
    _, tp = _params()
    batcher = ContinuousBatcher(Config(**TINY), tp, n_slots=2, max_seq_length=128,
                                weights_mode="quantized", decode_quantum=4, device="cpu")
    server = Server(batcher, FakeTokenizer(), port=0, model_name="srv-tiny").start()
    yield server
    server.stop()


def _post(port, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


@functools.lru_cache(maxsize=None)
def greedy(prompt: tuple, n_new: int) -> list:
    """The port engine's greedy tokens, checked against the JAX engine's."""
    jp, tp = _params()
    eng = InferenceEngine(Config(**TINY), tp, max_seq_length=128, weights_mode="quantized",
                          device="cpu")
    out = eng.generate(torch.tensor(prompt), len(prompt) + n_new)[0, len(prompt):].tolist()
    jeng = JaxEngine(JaxConfig(**TINY), jp, max_seq_length=128, weights_mode="quantized")
    ref = jeng.generate(jnp.asarray(prompt, jnp.int32), len(prompt) + n_new, temperature=0.0,
                        key=jax.random.PRNGKey(9))
    assert out == np.asarray(ref[0, len(prompt):]).tolist()
    return out


def test_generate_matches_engine(served):
    prompt = list(range(1, 11))
    want = greedy(tuple(prompt), 12)
    resp = json.load(_post(served.port, {"prompt": prompt, "max_new_tokens": 12}))
    assert resp["tokens"] == want
    assert resp["prompt_tokens"] == 10
    assert resp["finish_reason"] == "length"
    assert resp["text"] == FakeTokenizer().decode(want)


def test_text_prompt_and_health(served):
    want = greedy((3, 4, 5), 4)
    resp = json.load(_post(served.port, {"prompt": "t3 t4 t5", "max_new_tokens": 4}))
    assert resp["tokens"] == want
    health = json.load(urllib.request.urlopen(
        f"http://127.0.0.1:{served.port}/v1/health", timeout=30))
    assert health["status"] == "ok"
    assert health["model"] == "srv-tiny"
    assert health["n_slots"] == 2


def test_eos_stop(served):
    prompt = list(range(1, 11))
    ref = greedy(tuple(prompt), 20)
    eos = ref[4]
    resp = json.load(_post(served.port, {"prompt": prompt, "max_new_tokens": 20, "eos_id": eos}))
    assert resp["finish_reason"] == "stop"
    assert resp["tokens"] == ref[:ref.index(eos) + 1]
    # eos itself is not detokenized into the text
    assert resp["text"] == FakeTokenizer().decode(ref[:ref.index(eos)])


def test_streaming_sse(served):
    prompt = list(range(20, 28))
    want = greedy(tuple(prompt), 8)
    conn = _post(served.port, {"prompt": prompt, "max_new_tokens": 8, "stream": True})
    assert conn.headers["Content-Type"].startswith("text/event-stream")
    events, text = [], ""
    for raw in conn:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            break
        ev = json.loads(data)
        events.append(ev)
        text += ev["text"]
    assert [t for ev in events for t in ev["token_ids"]] == want
    assert text == FakeTokenizer().decode(want)


def test_concurrent_clients_share_slots(served):
    """4 clients on 2 slots: every client gets its own solo-run tokens."""
    prompts = [list(range(1, 6)), list(range(10, 17)), [5, 50, 7], list(range(30, 40))]
    want = [greedy(tuple(p), 6) for p in prompts]
    got = [None] * len(prompts)

    def worker(i):
        got[i] = json.load(_post(served.port, {"prompt": prompts[i], "max_new_tokens": 6}))[
            "tokens"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got == want


@pytest.mark.parametrize("body", [{"max_new_tokens": 4}, {"prompt": [1, 2], "max_new_tokens": "x"},
                                  {"prompt": [1, 2], "temperature": [0.5]}])
def test_bad_request_is_400(served, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served.port, body)
    assert e.value.code == 400
