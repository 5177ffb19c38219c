"""Multi-GPU serving in the port (fastmax_tpu_torch/parallel/, the engine's and
the batcher's mesh, the server, chat and generate command lines at --tp) on four gloo
ranks on the CPU, held against the JAX package on its 8 virtual CPU devices.

One group of ranks (collectives.spawn_local over torch_rank_checks.run_cases,
beside this file) runs every case of the file; each case builds its own (world // (tp*fsdp), fsdp,
tp) mesh over the four ranks, so a tp 2 case has a data axis of 2. The ranks
import no jax. Tolerances are the reference's (tests/test_sharding.py): the
sharded forward at atol 2e-4, rtol 1e-3; the sharded engine's greedy tokens
equal to the JAX engine's at f32; the batcher's greedy tokens under the
near-tie rule (equal, or a first divergence where the top-2 margin is under
2e-2 of the largest |logit|, chip_smoke.NEAR_TIE_REL).
"""

import builtins
import contextlib
import io
import sys
import json
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference import chat as jchat
from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.parallel import sharding as jsh
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.tokenizer import Tokenizer
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.parallel import collectives as col
from fastmax_tpu_torch.parallel import sharding

torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)

WORLD = 4
SMALL = dict(name="shard-test", block_size=64, vocab_size=128, padded_vocab_size=128,
             n_layer=2, n_head=8, n_embd=64, n_query_groups=4, rotary_percentage=1.0,
             parallel_residual=False, bias=False, _norm_class="RMSNorm", _mlp_class="LLaMAMLP",
             intermediate_size=128)
NF4 = {**SMALL, "n_embd": 128, "intermediate_size": 256, "n_query_groups": 8}
FORWARD = [(2, 1), (1, 2), (2, 2)]
NEAR_TIE_REL = 2e-2
TEXT = "hello world this is a tiny tokenizer for the chat and generate tools"
CLI_TINY = dict(name="tp-cli-tiny", block_size=128, n_layer=2, n_head=4, n_embd=128,
                n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
                _mlp_class="LLaMAMLP", bias=False, parallel_residual=False)
PROMPTS = ["hello world", "the chat and generate"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def train_tokenizer(d: Path, vocab_size: int = 120) -> int:
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    tok = HFTok(BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator([TEXT] * 20, BpeTrainer(
        special_tokens=["[UNK]", "<eos>", "<s>"], vocab_size=vocab_size))
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<eos>"}))
    return tok.get_vocab_size()


def batcher_inputs():
    """Four 10-token prompts opening with one 6-token prefix."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, 128, 6).tolist()
    return prefix, [prefix + rng.integers(1, 128, 4).tolist() for _ in range(4)]


BATCHERS = {
    "prefix_chunked": (SMALL, dict(n_slots=2, max_seq_length=64, prefix_cache_size=4,
                                   prefill_chunk=8), True),
    "speculative": (SMALL, dict(n_slots=2, max_seq_length=64, speculative_k=3), False),
    "linear_fastmax": ({**SMALL, "attn_alg": "fastmax"}, dict(n_slots=2, max_seq_length=64),
                       False),
}
N_NEW = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, then one group of four ranks over every case: {name: rank 0's result}."""
    params = jgpt.init_params(JaxConfig(**SMALL), jax.random.PRNGKey(0))
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128))
    qparams = jquant.quantize_model(jgpt.init_params(JaxConfig(**NF4), jax.random.PRNGKey(0)),
                                    "bnb.nf4")
    nf4_idx = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, 128))
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (12,), 1, 128))
    prompts2 = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (2, 12), 1, 128))
    fparams = jgpt.init_params(JaxConfig(**BATCHERS["linear_fastmax"][0]),
                               jax.random.PRNGKey(0))

    d = tmp_path_factory.mktemp("tp_ckpt")
    vocab = train_tokenizer(d)
    ccfg = JaxConfig(**{**CLI_TINY, "vocab_size": vocab, "padded_vocab_size": vocab})
    jckpt.save_flat_checkpoint(jparams.params_to_flat(
        jgpt.init_params(ccfg, jax.random.PRNGKey(0)), ccfg), d)
    ccfg.to_json(d / "lit_config.json")

    p_np = np_tree(params)
    prefix, prompts = batcher_inputs()
    cases = [(f"fwd_{tp}_{fs}", "forward", dict(cfg=SMALL, params=p_np, idx=idx, tp=tp,
                                                 fsdp=fs)) for tp, fs in FORWARD]
    cases.append(("nf4", "forward", dict(cfg=NF4, params=np_tree(qparams), idx=nf4_idx, tp=2,
                                         fsdp=1)))
    for dt in ("float32", "int8"):
        cases.append((f"engine_{dt}", "engine", dict(cfg=SMALL, params=p_np, prompt=prompt,
                                                     n_ret=24, tp=2, fsdp=2, cache_dtype=dt)))
    cases.append(("engine_batch2", "engine", dict(cfg=SMALL, params=p_np, prompt=prompts2,
                                                  n_ret=20, tp=2, fsdp=2)))
    cases.append(("gather", "gather_roundtrip", dict(x=np.arange(32, dtype=np.float32)
                                                     .reshape(4, 8))))
    cases.append(("hybrid", "hybrid_mesh", dict(data=2, fsdp=1, model=2, granule_size=2)))
    for name, (cfg, kw, pre) in BATCHERS.items():
        cases.append((f"batcher_{name}", "batcher", dict(
            cfg=cfg, params=np_tree(fparams) if cfg is not SMALL else p_np, prompts=prompts,
            n_new=N_NEW, tp=2, kw=kw, prefix=prefix if pre else None)))
    common = ["--checkpoint_dir", str(d), "--precision", "float32", "--device", "cpu"]
    cases.append(("generate", "generate_cli", dict(flags=[
        "--prompt", PROMPTS[0], "--max_new_tokens", "6", "--temperature", "0", "--tp", "2"]
        + common)))
    cases.append(("server", "server_cli", dict(flags=[
        "--host", "127.0.0.1", "--port", "0", "--n_slots", "2", "--tp", "2"] + common,
        bodies=[{"prompt": p, "max_new_tokens": 6} for p in PROMPTS])))
    cases.append(("chat", "chat_cli", dict(flags=[
        "--max_new_tokens", "6", "--temperature", "0", "--tp", "2"] + common, prompts=PROMPTS)))

    import torch_rank_checks as rank_checks

    # the ranks run while the tests compute the JAX references (``result``)
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(col.spawn_local, rank_checks.run_cases, WORLD, args=(cases,),
                        timeout=300)
    pool.shutdown(wait=False)
    return {"ranks": ranks, "params": params, "idx": idx, "qparams": qparams, "nf4_idx": nf4_idx,
            "prompt": prompt, "prompts2": prompts2, "fparams": fparams, "ckpt": d, "prefix": prefix,
            "prompts": prompts}


def result(world) -> dict:
    """Rank 0's results of every case (waits for the group)."""
    return world["ranks"].result()[0]


@pytest.mark.parametrize("tp,fsdp", FORWARD)
def test_sharded_forward_matches_single_device(world, tp, fsdp):
    ref, _ = jgpt.forward(world["params"], JaxConfig(**SMALL), jnp.asarray(world["idx"]))
    got = result(world)[f"fwd_{tp}_{fsdp}"]
    assert got["kept_whole"] == []
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_quantized_params_shard(world):
    """NF4 blocks survive the tp 2 split (q4 and absmax cut on block lines)."""
    ref, _ = jgpt.forward(world["qparams"], JaxConfig(**NF4), jnp.asarray(world["nf4_idx"]))
    got = result(world)["nf4"]
    assert got["kept_whole"] == []
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_tp_engine_decode_with_sharded_cache(world, cache_dtype):
    """fsdp 2 x model 2: each rank's fresh cache is its block of the reference's
    kv_cache_specs (groups over model; the batch of 1 stays whole), and the
    greedy tokens equal the JAX engine's on the same mesh."""
    cfg = JaxConfig(**SMALL)
    mesh = jsh.make_mesh(data=1, fsdp=2, model=2)
    specs = jsh.param_specs(cfg, world["params"], tp=True, fsdp_size=2)
    jeng = JaxEngine(cfg, jsh.shard_params(world["params"], mesh, specs), max_seq_length=32,
                     batch_size=1, cache_dtype=getattr(jnp, cache_dtype), mesh=mesh)
    with mesh:
        ref = jeng.generate(jnp.asarray(world["prompt"]), 24, temperature=0.0,
                            key=jax.random.PRNGKey(2))
    got = result(world)[f"engine_{cache_dtype}"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(ref))

    whole = gpt.init_kv_cache(Config(**SMALL), 1, 32, getattr(torch, cache_dtype), "cpu")
    assert set(whole) == ({"k", "v", "k_scale", "v_scale"} if cache_dtype == "int8"
                          else {"k", "v"})
    want = sharding.kv_cache_specs(Config(**SMALL))
    jwant = jsh.kv_cache_specs(cfg)
    sizes = {"data": 1, "fsdp": 2, "model": 2}
    for name in whole:
        spec = sharding.sanitize_spec(want[name], tuple(whole[name].shape), sizes)
        assert spec == tuple(jsh.sanitize_spec(jwant[name], whole[name].shape, mesh))
    for coords, shapes in got["caches"]:
        blocks = sharding.shard_kv_cache(whole, SimpleNamespace(shape=sizes, coords=coords),
                                         Config(**SMALL))
        assert {k: list(v.shape) for k, v in blocks.items()} == shapes, coords


def test_tp_engine_splits_the_batch_over_fsdp(world):
    """A batch of 2 on fsdp 2 x model 2: each fsdp rank decodes its row (the
    cache holds one row of its two groups), the rows are gathered at the end,
    and the greedy tokens equal the JAX engine's."""
    jeng = JaxEngine(JaxConfig(**SMALL), world["params"], max_seq_length=28, batch_size=2)
    ref = jeng.generate(jnp.asarray(world["prompts2"]), 20, temperature=0.0,
                        key=jax.random.PRNGKey(2))
    got = result(world)["engine_batch2"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(ref))
    assert all(shapes["k"][1:3] == [1, 2] for _, shapes in got["caches"])


def test_gather_fsdp_local_roundtrip(world):
    """ZeRO-3's manual gather: a leaf cut over fsdp comes back whole on every rank."""
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    for a, b in result(world)["gather"]:
        np.testing.assert_array_equal(a, x)
        np.testing.assert_array_equal(b, x[:, :4])


def test_hybrid_mesh_on_ranks(world):
    """make_hybrid_mesh on four ranks in two simulated granules of 2: each rank
    sits where the JAX mesh puts the same device, and the placement holds."""
    jmesh = jsh.make_hybrid_mesh(data=2, fsdp=1, model=2, devices=jax.devices()[:4],
                                 granule_size=2)
    jids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, (layout, coords) in enumerate(result(world)["hybrid"]):
        np.testing.assert_array_equal(layout, jids)
        assert jids[coords["data"], coords["fsdp"], coords["model"]] == rank


def near_tie(cfg: dict, params, prompt, want, got) -> None:
    """Equal tokens, or a first divergence at a near-tie of the one-rank port's logits."""
    diff = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    assert len(want) == len(got)
    if not diff:
        return
    i = diff[0]
    seq = torch.tensor([list(prompt) + list(want[:i])])
    logits, _ = gpt.forward(from_numpy_params(np_tree(params), "cpu"), Config(**cfg), seq)
    top = torch.topk(logits[0, -1], 2).values
    margin, big = float(top[0] - top[1]), float(logits[0, -1].abs().max())
    assert margin <= NEAR_TIE_REL * big, (i, margin, big)


@pytest.mark.parametrize("name", list(BATCHERS))
def test_tp_batcher_matches_the_jax_engine(world, name):
    """The batcher at tp 2 (rank 0 schedules and broadcasts the plan and the
    tokens, the others follow): each request's greedy tokens are the JAX
    engine's for its prompt, by the near-tie rule; the prefix cache and the
    speculative verify did their work; the linear arm keeps its attention
    whole and splits its MLP."""
    cfg, kw, _ = BATCHERS[name]
    params = world["fparams"] if cfg is not SMALL else world["params"]
    jeng = JaxEngine(JaxConfig(**cfg), params, max_seq_length=64)
    got = result(world)[f"batcher_{name}"]
    for p, toks in zip(world["prompts"], got["tokens"]):
        ref = jeng.generate(jnp.asarray(p, jnp.int32), len(p) + N_NEW, temperature=0.0,
                            key=jax.random.PRNGKey(0))
        near_tie(cfg, params, p, np.asarray(ref[0, len(p):]).tolist(), toks)
    stats = got["stats"]
    if name == "prefix_chunked":
        assert stats["prefix_cache_hits"] >= 6 * len(world["prompts"])
    if name == "speculative":
        assert stats["spec_drafted"] > 0
    assert stats["kept_whole"] == (["attn.attn", "attn.proj"] if name == "linear_fastmax"
                                   else [])


def jax_greedy(d: Path, prompt: str, n_new: int) -> list:
    cfg, params = jckpt.load_model_params(d)
    enc = Tokenizer(d).encode(prompt)
    eng = JaxEngine(cfg, params, max_seq_length=len(enc) + n_new)
    out = eng.generate(jnp.asarray(enc, jnp.int32), len(enc) + n_new, temperature=0.0,
                       eos_id=Tokenizer(d).eos_id, key=jax.random.PRNGKey(0))
    return np.asarray(out[0, len(enc):]).tolist()


def test_generate_tp_prints_the_jax_text(world):
    """``generate --tp 2`` on the ranks (the dense checkpoint read slice by slice):
    rank 0 prints the JAX command line's text."""
    d = world["ckpt"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        jgenerate.main(prompt=PROMPTS[0], checkpoint_dir=d, max_new_tokens=6, temperature=0.0,
                       precision="float32")
    assert result(world)["generate"].strip() == buf.getvalue().strip()
    assert buf.getvalue().strip()


def test_server_tp_answers_over_http(world):
    """The server at --tp 2: rank 0 answers two requests over 127.0.0.1 with the
    JAX engine's greedy tokens, then stops as on Ctrl-C and so do the followers."""
    d = world["ckpt"]
    answers = result(world)["server"]
    assert len(answers) == len(PROMPTS)
    for p, a in zip(PROMPTS, answers):
        assert a["tokens"] == jax_greedy(d, p, 6)[:len(a["tokens"])]
        assert a["tokens"] and a["finish_reason"] in ("length", "stop")


def test_chat_tp_prints_the_jax_replies(world, monkeypatch):
    """Chat at --tp 2: rank 0 reads two prompts and then an empty line, which ends
    every rank's session, and prints the JAX chat's text for the same input."""
    d = world["ckpt"]
    # the reference's decode_stream binds sys.stdout when it is defined: send its
    # reply to the stdout read here, as the port's does
    real = jchat.decode_stream
    monkeypatch.setattr(jchat, "decode_stream",
                        lambda tok, stream, out=None: real(tok, stream, sys.stdout))
    answers = iter(PROMPTS + [""])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        jchat.main(checkpoint_dir=d, precision="float32", max_new_tokens=6, temperature=0.0)
    got = result(world)["chat"]
    assert got == buf.getvalue() and got.count(">> Reply: ") == len(PROMPTS)
    assert got.split(">> Reply: ")[1].strip()
