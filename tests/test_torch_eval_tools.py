"""The port's evaluation, data and checkpoint command lines against the JAX
package on the CPU: ``models/tokenizer.py``, ``scripts/prepare_alpaca.py``
(with ``data/prompts.py``), ``eval/harness.py``,
``scripts/convert_lit_checkpoint.py``, ``scripts/merge_lora.py``,
``models/lora.merge_lora`` into quantized bases and
``scripts/convert_pretrained_checkpoint.py``; and every flag of these
command lines whose item is not ported yet raising with the item's ID.

Token ids, ``.npz`` examples, converted and merged files and requantized
codes are held bit for bit; eval scores (float32) within 1e-4 relative and
absolute of the JAX package's.
"""

import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.eval import harness as jharness
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import lora as jlora
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.scripts import convert_lit_checkpoint as jlit
from fastmax_tpu.scripts import convert_pretrained_checkpoint as jpre
from fastmax_tpu.scripts import merge_lora as jmerge
from fastmax_tpu.scripts import prepare_alpaca as jprep
from fastmax_tpu.training import fit as jfit
from fastmax_tpu.training.finetune import _flatten_delta
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu_torch.eval import harness
from fastmax_tpu_torch.inference import bench_serving, chat, generate, server
from fastmax_tpu_torch.models import lora
from fastmax_tpu_torch.models.tokenizer import Tokenizer
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.scripts import convert_lit_checkpoint as tlit
from fastmax_tpu_torch.scripts import convert_pretrained_checkpoint as tpre
from fastmax_tpu_torch.scripts import merge_lora as tmerge
from fastmax_tpu_torch.scripts import prepare_alpaca as tprep
from fastmax_tpu_torch.training.fit import TrainState, save_train_state
from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint, load_model_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
TINY = dict(name="eval-tiny-gqa", block_size=128, n_layer=2, n_head=4, n_embd=64,
            n_query_groups=2, rotary_percentage=1.0, parallel_residual=False, bias=False,
            _norm_class="RMSNorm", _mlp_class="LLaMAMLP", intermediate_size=128)
NEOX = dict(name="eval-tiny-neox", block_size=64, vocab_size=96, padded_vocab_size=96,
            n_layer=2, n_head=4, n_embd=64, intermediate_size=256, rotary_percentage=0.25,
            parallel_residual=True, bias=True)
TEXT = "hello world this is a tiny tokenizer for the chat and generate tools"
RECORDS = [
    {"instruction": "write the fox", "input": "", "output": "the quick brown fox"},
    {"instruction": "respond", "input": "quick", "output": "responses to instructions"},
    {"instruction": "say hello", "input": "world", "output": "hello world"},
] * 4
TOL = dict(rtol=1e-4, atol=1e-4)


def train_tokenizer(d: Path, texts=(TEXT,), vocab_size: int = 120):
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    tok = HFTok(BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(list(texts) * 20, BpeTrainer(
        special_tokens=["[UNK]", "<eos>", "<s>"], vocab_size=vocab_size))
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    return tok.get_vocab_size()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(directory, JAX config, JAX params), written by the JAX package."""
    d = tmp_path_factory.mktemp("ckpt")
    vocab = train_tokenizer(d)
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<eos>"}))
    cfg = JaxConfig(**{**TINY, "vocab_size": vocab, "padded_vocab_size": vocab})
    params = jgpt.init_params(cfg, jax.random.PRNGKey(0))
    jckpt.save_flat_checkpoint(jparams.params_to_flat(params, cfg), d)
    cfg.to_json(d / "lit_config.json")
    return d, cfg, params


def lms(ckpt, **kw):
    """(JAX FastmaxLM, port FastmaxLM) over the same directory, float32."""
    d = ckpt[0]
    jcfg, jp = jckpt.load_model_params(d)
    cfg, tp = load_model_params(d, device="cpu")
    return (jharness.FastmaxLM(jcfg, jp, JaxTokenizer(d), **kw),
            harness.FastmaxLM(cfg, tp, Tokenizer(d), **kw))


# ------------------------------------------------------------------ tokenizer


TOKENIZER_CONFIGS = {
    "eos_string": ({"eos_token": "<eos>"}, None),
    "added_token_dicts": ({"bos_token": {"content": "<s>", "lstrip": False},
                           "eos_token": {"content": "<eos>"}, "add_bos_token": True}, None),
    "generation_config_ids": (None, {"bos_token_id": 2, "eos_token_id": 1}),
    "llama_class_and_generation": ({"tokenizer_class": "LlamaTokenizer", "eos_token": "<eos>"},
                                   {"bos_token_id": 2, "eos_token_id": 7}),
}


@pytest.mark.parametrize("case", list(TOKENIZER_CONFIGS))
def test_tokenizer_ids_equal_jax(tmp_path, case):
    tok_cfg, gen_cfg = TOKENIZER_CONFIGS[case]
    train_tokenizer(tmp_path)
    if tok_cfg is not None:
        (tmp_path / "tokenizer_config.json").write_text(json.dumps(tok_cfg))
    if gen_cfg is not None:
        (tmp_path / "generation_config.json").write_text(json.dumps(gen_cfg))
    j, t = JaxTokenizer(tmp_path), Tokenizer(tmp_path)
    for attr in ("use_bos", "bos_id", "eos_id", "vocab_size", "backend"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for text in ("hello world", "the chat and generate tools", ""):
        for bos in (None, False) + ((True,) if j.bos_id is not None else ()):
            for eos in (False, True):
                for max_length in (-1, 3):
                    want = j.encode(text, bos=bos, eos=eos, max_length=max_length)
                    got = t.encode(text, bos=bos, eos=eos, max_length=max_length)
                    assert got.dtype == want.dtype == np.int32
                    np.testing.assert_array_equal(got, want)
                    assert t.decode(got) == j.decode(want)
    if j.bos_id is None:
        with pytest.raises(NotImplementedError, match="bos"):
            t.encode("hello", bos=True)


def test_tokenizer_missing_files_and_backends(tmp_path):
    with pytest.raises(NotADirectoryError):
        Tokenizer(tmp_path / "absent")
    with pytest.raises(NotImplementedError, match="no tokenizer files"):
        Tokenizer(tmp_path)
    (tmp_path / "tokenizer.model").write_bytes(b"\0")
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="sentencepiece"):
            Tokenizer(tmp_path)
        with pytest.raises(ImportError, match="sentencepiece"):
            JaxTokenizer(tmp_path)


# ------------------------------------------------------------------ prepare_alpaca


def _write_records(path: Path, records: list) -> Path:
    if path.suffix == ".json":
        path.write_text(json.dumps(records))
    elif path.suffix == ".jsonl":
        path.write_text("".join(json.dumps(r) + "\n" for r in records))
    else:
        import csv

        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(records[0]))
            w.writeheader()
            w.writerows(records)
    return path


STYLE_CASES = {
    "alpaca": ("alpaca", ".json", RECORDS, {}),
    "dolly": ("dolly", ".jsonl", [{"instruction": r["instruction"], "context": r["input"],
                                   "response": r["output"]} for r in RECORDS], {}),
    "flan": ("flan", ".json", [{"inputs": r["instruction"], "targets": r["output"]}
                               for r in RECORDS], {}),
    "lima": ("lima", ".json", [{"conversations": ["say hello", "hello world", "respond",
                                                  "the quick brown fox"]}] * 6, {}),
    "lima_multiturn": ("lima", ".json", [{"conversations": ["say hello", "hello world",
                                                            "respond", "the quick fox"]}] * 6,
                       {"include_multiturn": True}),
    "csv": ("csv", ".csv", RECORDS, {}),
    "jsonl": ("alpaca", ".jsonl", RECORDS, {"mask_inputs": False}),
}


@pytest.mark.parametrize("case", list(STYLE_CASES))
def test_prepare_alpaca_npz_equals_jax(ckpt, tmp_path, case, capsys):
    style, suffix, records, extra = STYLE_CASES[case]
    data = _write_records(tmp_path / f"records{suffix}", records)
    kw = dict(data_file=data, checkpoint_dir=ckpt[0], test_split_fraction=0.25,
              max_seq_length=24, style=style, **extra)
    jprep.prepare(destination_path=tmp_path / "j", **kw)
    want_out = capsys.readouterr().out
    flags = [f"--{k}={v}" for k, v in kw.items()]
    tprep.main(flags + ["--destination_path", str(tmp_path / "t")])
    assert capsys.readouterr().out == want_out.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    for split in ("train", "test"):
        want = np.load(tmp_path / "j" / f"{split}.npz", allow_pickle=True)["examples"]
        got = np.load(tmp_path / "t" / f"{split}.npz", allow_pickle=True)["examples"]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["input_ids", "labels"]
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    from fastmax_tpu_torch.data.lm_datasets import SFTDataset

    inputs, labels = SFTDataset.load(tmp_path / "t" / "train.npz").sample_batch(2, 24)
    assert inputs.shape == labels.shape


# ------------------------------------------------------------------ eval harness


LL_REQUESTS = [("hello world", " this is"), ("a tiny tokenizer chat hello world this", " is a"),
               ("chat", " hello"), ("hello world this is", " a tiny tokenizer"),
               ("tokenizer", " chat chat")]


def test_loglikelihood_batched_and_serial_equal_jax(ckpt):
    jlm, tlm = lms(ckpt, batch_size=1)
    want = jlm.loglikelihood(LL_REQUESTS)
    serial = tlm.loglikelihood(LL_REQUESTS)
    tlm.batch_size = 4
    batched = tlm.loglikelihood(LL_REQUESTS)
    for (lw, gw), (ls, gs), (lb, gb) in zip(want, serial, batched):
        np.testing.assert_allclose([ls, lb], [lw, lw], **TOL)
        assert gw == gs == gb
        assert ls < 0


def test_multiple_choice_accuracy_on_the_repo_task_equals_jax(ckpt, tmp_path):
    records = json.loads((REPO / "eval_assets" / "tasks" / "code_cloze.json").read_text())[:6]
    task = tmp_path / "task.json"
    task.write_text(json.dumps(records))
    jlm, tlm = lms(ckpt, batch_size=4)
    assert harness.multiple_choice_accuracy(tlm, task) == jharness.multiple_choice_accuracy(
        jlm, task)
    reqs = [(r["query"], " " + c) for r in records for c in r["choices"]]
    np.testing.assert_allclose([x for x, _ in tlm.loglikelihood(reqs)],
                               [x for x, _ in jlm.loglikelihood(reqs)], **TOL)


def test_rolling_loglikelihood_and_perplexity_equal_jax(ckpt):
    jlm, tlm = lms(ckpt, max_seq_length=32, batch_size=2)
    toks = [int(x) for x in np.random.default_rng(0).integers(1, ckpt[1].vocab_size, 3 * 32)]
    np.testing.assert_allclose(tlm.loglikelihood_rolling_tokens(toks),
                               jlm.loglikelihood_rolling_tokens(toks), **TOL)
    stream = Tokenizer(ckpt[0]).encode("hello world this is a tiny " * 10)
    for stride in (512, 16):
        np.testing.assert_allclose(harness.perplexity_on_tokens(tlm, stream, stride),
                                   jharness.perplexity_on_tokens(jlm, stream, stride), **TOL)


def test_greedy_until_and_caching_lm(ckpt, tmp_path):
    jlm, tlm = lms(ckpt, max_seq_length=64, batch_size=2)
    for stop in ((), ("is",)):
        assert tlm.greedy_until("hello world", 8, stop) == jlm.greedy_until("hello world", 8,
                                                                            stop)
    cached = harness.CachingLM(tlm, tmp_path / "cache.json")
    first = cached.loglikelihood(LL_REQUESTS)
    tlm.loglikelihood = lambda requests: pytest.fail("a warm cache called the model")
    assert harness.CachingLM(tlm, tmp_path / "cache.json").loglikelihood(LL_REQUESTS) == first


def test_token_id_methods_need_no_tokenizer(ckpt):
    cfg, tp = load_model_params(ckpt[0], device="cpu")
    lm = harness.FastmaxLM(cfg, tp, None, batch_size=2)
    reqs = [([1, 5, 9], [3, 4]), ([7], [8, 2, 2])]
    with_tok = harness.FastmaxLM(cfg, tp, Tokenizer(ckpt[0]), batch_size=2)
    assert lm.loglikelihood_tokens_batch(reqs) == with_tok.loglikelihood_tokens_batch(reqs)
    assert np.isfinite(harness.perplexity_on_tokens(lm, np.arange(1, 40)))


def _stub_lm_eval(monkeypatch, captured):
    class Instance:
        def __init__(self, args):
            self.args = args

    class LM:
        pass

    def simple_evaluate(model=None, tasks=None, num_fewshot=0, limit=None):
        assert isinstance(model, LM)
        captured["lls"] = model.loglikelihood(
            [Instance(("hello world", " this is")), Instance(("a tiny", " tokenizer"))])
        captured["roll"] = model.loglikelihood_rolling(
            [Instance(("hello world this is a tiny tokenizer for the chat tools",))])
        captured["gen"] = model.generate_until([Instance(("hello world", {"until": ["\n"]}))])
        captured["tasks"] = tasks
        return {"results": {t: {"acc": 0.5} for t in tasks}}

    pkg, api, model_mod = (types.ModuleType(n) for n in ("lm_eval", "lm_eval.api",
                                                         "lm_eval.api.model"))
    model_mod.LM, api.model, pkg.api, pkg.simple_evaluate = LM, model_mod, api, simple_evaluate
    for name, mod in (("lm_eval", pkg), ("lm_eval.api", api), ("lm_eval.api.model", model_mod)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_stubbed_lm_eval_equals_jax(ckpt, monkeypatch):
    jlm, tlm = lms(ckpt, max_seq_length=64, batch_size=2)
    want, got = {}, {}
    _stub_lm_eval(monkeypatch, want)
    jres = jharness._run_lm_eval(jlm, ["arc_stub", "piqa_stub"], 0, None)
    _stub_lm_eval(monkeypatch, got)
    tres = harness._run_lm_eval(tlm, ["arc_stub", "piqa_stub"], 0, None)
    assert tres == jres and got["tasks"] == want["tasks"] == ["arc_stub", "piqa_stub"]
    np.testing.assert_allclose([x for x, _ in got["lls"]], [x for x, _ in want["lls"]], **TOL)
    assert [g for _, g in got["lls"]] == [g for _, g in want["lls"]]
    np.testing.assert_allclose(got["roll"][0][0], want["roll"][0][0], **TOL)
    assert got["gen"] == want["gen"] and isinstance(got["gen"][0], str)


def test_run_eval_harness_main_equals_jax(ckpt, tmp_path, capsys):
    records = json.loads((REPO / "eval_assets" / "tasks" / "code_cloze.json").read_text())[:4]
    task = tmp_path / "task.json"
    task.write_text(json.dumps(records))
    text = tmp_path / "ppl.txt"
    text.write_text("hello world this is a tiny tokenizer " * 8)
    kw = dict(checkpoint_dir=ckpt[0], local_task_file=task, ppl_text_file=text, batch_size=4)
    want = jharness.run_eval_harness(**kw, save_filepath=tmp_path / "j.json")
    got = harness.main([f"--{k}={v}" for k, v in kw.items()]
                       + ["--save_filepath", str(tmp_path / "t.json"), "--device", "cpu"])
    assert got["local_task"] == want["local_task"] and got["model"] == want["model"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], **TOL)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    if "lm_eval" not in sys.modules:
        for run in (jharness.run_eval_harness, harness.run_eval_harness):
            with pytest.raises(ImportError, match="lm_eval package is not installed"):
                run(ckpt[0], tasks="arc_challenge",
                    **({"device": "cpu"} if run is harness.run_eval_harness else {}))


# ------------------------------------------------------------------ converters


@pytest.fixture(scope="module")
def neox_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("neox")
    cfg = JaxConfig(**NEOX)
    jckpt.save_flat_checkpoint(
        jparams.params_to_flat(jgpt.init_params(cfg, jax.random.PRNGKey(3)), cfg), d)
    cfg.to_json(d / "lit_config.json")
    return d


def _assert_files_equal(got: Path, want: Path):
    a, b = load_flat_checkpoint(got), jckpt.load_flat_checkpoint(want)
    assert sorted(a) == sorted(b) and a
    for k in b:
        w = np.asarray(b[k])
        assert a[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(a[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("family", ["llama_gqa", "neox"])
@pytest.mark.parametrize("layout", ["model.safetensors", "npy_dir"])
def test_convert_lit_checkpoint_equals_jax(ckpt, neox_dir, tmp_path, family, layout):
    src = ckpt[0] if family == "llama_gqa" else neox_dir
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jlit.convert_lit_checkpoint(src, tmp_path / "j" / layout)
    tlit.main(["--checkpoint_path", str(src), "--output_path", str(tmp_path / "t" / layout)])
    _assert_files_equal(tmp_path / "t" / layout, tmp_path / "j" / layout)


def test_convert_lit_refuses_unmerged_lora(ckpt, tmp_path):
    d, cfg, params = ckpt
    lp = jlora.add_lora_params(params, cfg, jlora.LoRAConfig(r=2), jax.random.PRNGKey(1))
    bad = tmp_path / "lora_dir"
    bad.mkdir()
    (bad / "lit_config.json").write_text((d / "lit_config.json").read_text())
    flat = {**jparams.params_to_flat(params, cfg),
            "transformer.h.0.attn.attn.lora_A": np.asarray(
                lp["blocks"]["attn"]["attn"]["lora_A"][0])}
    jckpt.save_flat_checkpoint(flat, bad / "model.safetensors")
    with pytest.raises(ValueError, match="merge it first"):
        tlit.convert_lit_checkpoint(bad, tmp_path / "out.safetensors")


def _lora_file(ckpt, path: Path, **lcfg) -> Path:
    d, cfg, params = ckpt
    lp = jlora.add_lora_params(params, cfg, jlora.LoRAConfig(**lcfg), jax.random.PRNGKey(1))
    lp = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 if "lora_B" in str(p[-1]) else x, lp)
    jckpt.save_flat_checkpoint(_flatten_delta(jlora.split_lora_state(lp)[1]), path)
    return path


def test_merge_lora_cli_writes_the_jax_files(ckpt, tmp_path, capsys):
    delta = _lora_file(ckpt, tmp_path / "lora.safetensors", r=2, alpha=4, projection=True,
                       mlp=True)
    jmerge.merge_lora(ckpt[0], delta, tmp_path / "j")
    tmerge.main(["--checkpoint_dir", str(ckpt[0]), "--lora_path", str(delta), "--out_dir",
                 str(tmp_path / "t"), "--device", "cpu"])
    assert "merged checkpoint ->" in capsys.readouterr().out
    _assert_files_equal(tmp_path / "t", tmp_path / "j")
    assert (json.loads((tmp_path / "t" / "lit_config.json").read_text())
            == json.loads((tmp_path / "j" / "lit_config.json").read_text()))


# ------------------------------------------------------------------ merge into quantized bases


@pytest.mark.parametrize("mode", ["bnb.nf4", "bnb.nf4-dq", "bnb.fp4", "bnb.int8", "gptq.int4"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
def test_merge_lora_into_a_quantized_base_equals_jax(mode, stacked):
    rng = np.random.default_rng(5)
    lead = (2,) if stacked else ()
    kernel = rng.standard_normal(lead + (128, 96)).astype(np.float32) * 0.05
    if stacked:
        q = [jax.tree.map(np.asarray, jquant.quantize_linear_params({"kernel": k}, mode))
             for k in kernel]
        p = {k: np.stack([x[k] for x in q]) for k in q[0]}
    else:
        p = jax.tree.map(np.asarray, jquant.quantize_linear_params({"kernel": kernel}, mode))
    p.update({"lora_A": rng.standard_normal(lead + (128, 4)).astype(np.float32) * 0.1,
              "lora_B": rng.standard_normal(lead + (4, 96)).astype(np.float32) * 0.1,
              "lora_scale": np.full(lead, 2.0, np.float32),
              "lora_mask": (rng.random(lead + (96,)) > 0.3).astype(np.float32),
              "bias": rng.standard_normal(lead + (96,)).astype(np.float32)})
    want = jax.tree.map(np.asarray, jlora.merge_lora({"blocks": {"attn": {"attn": p}}}))
    got = lora.merge_lora({"blocks": {"attn": {"attn": from_numpy_params(p, "cpu")}}})
    want, got = want["blocks"]["attn"]["attn"], got["blocks"]["attn"]["attn"]
    assert sorted(got) == sorted(want) and not any(k.startswith("lora_") for k in got)
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the merge moved the codes: the delta reached the requantized weights
    code_key = "q8" if mode == "bnb.int8" else "q4"
    assert not np.array_equal(want[code_key], p[code_key])


def test_merge_lora_folds_a_dense_delta_bit_for_bit():
    rng = np.random.default_rng(6)
    p = {"kernel": rng.standard_normal((2, 64, 48)).astype(np.float32),
         "lora_A": rng.standard_normal((2, 64, 8)).astype(np.float32),
         "lora_B": rng.standard_normal((2, 8, 48)).astype(np.float32),
         "lora_scale": np.full((2,), 0.5, np.float32)}
    want = jax.tree.map(np.asarray, jlora.merge_lora({"mlp": p}))["mlp"]["kernel"]
    got = lora.merge_lora({"mlp": from_numpy_params(p, "cpu")})["mlp"]["kernel"].numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ convert_pretrained


def test_convert_pretrained_from_jax_final_and_port_state(ckpt, tmp_path, capsys):
    d, cfg, params = ckpt
    # a JAX pretraining out_dir after its run: final/ (npy layout + lit_config.json)
    jout = tmp_path / "jax_out"
    jckpt.save_flat_checkpoint(jparams.params_to_flat(params, cfg), jout / "final")
    cfg.to_json(jout / "final" / "lit_config.json")
    tok_dir = d
    (tok_dir / "generation_config.json").write_text(json.dumps({"eos_token_id": 1}))
    jpre.convert_pretrained_checkpoint(jout, tmp_path / "j", tok_dir)
    tpre.main(["--checkpoint_dir", str(jout), "--output_dir", str(tmp_path / "t"),
               "--tokenizer_dir", str(tok_dir)])
    assert "deployable checkpoint ->" in capsys.readouterr().out
    _assert_files_equal(tmp_path / "t", tmp_path / "j")
    for name in ("lit_config.json", "tokenizer.json", "tokenizer_config.json",
                 "generation_config.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()

    # the port's own out_dir: state/train_state.pt, lit_config.json at the top
    pout = tmp_path / "port_out"
    tree = from_numpy_params(jax.tree.map(np.asarray, params), "cpu")
    save_train_state(TrainState(tree, {"step": torch.tensor(3)}, 3), pout / "state")
    cfg.to_json(pout / "lit_config.json")
    tpre.convert_pretrained_checkpoint(pout, tmp_path / "t2")
    _assert_files_equal(tmp_path / "t2", tmp_path / "j")


def test_convert_pretrained_refuses_an_orbax_state(ckpt, tmp_path):
    d, cfg, params = ckpt
    out = tmp_path / "jax_out"
    jfit.save_train_state(jfit.TrainState(params, {}, 2), out / "state")
    jckpt.save_flat_checkpoint(jparams.params_to_flat(params, cfg), out / "final")
    cfg.to_json(out / "final" / "lit_config.json")
    jpre.convert_pretrained_checkpoint(out, tmp_path / "j")  # the reference reads it
    assert (tmp_path / "j" / "model" / "index.json").is_file()
    with pytest.raises(ValueError, match="orbax"):
        tpre.convert_pretrained_checkpoint(out, tmp_path / "t")


# ------------------------------------------------------------------ unported flags


UNPORTED = {
    # ported since (A8 slice 1): started alone at tp or fsdp > 1, each refuses with the
    # torchrun line (tests/test_torch_tp_serving.py runs them on gloo ranks)
    "generate_tp": (lambda d: refuses_alone(
        lambda: generate.main(checkpoint_dir=d, tp=2, device="cpu")), None),
    "generate_fsdp": (lambda d: refuses_alone(
        lambda: generate.main(checkpoint_dir=d, fsdp=2, device="cpu")), None),
    # ported since (A1): speculative decoding runs (tests/test_torch_speculative_serving.py
    # holds its text, tokens and acceptance against the JAX package's)
    "generate_speculative_k": (lambda d: speculative_generate_runs(
        d, ["--speculative_k", "4"]), None),
    "generate_draft": (lambda d: speculative_generate_runs(
        d, ["--speculative_k", "2", "--draft_checkpoint_dir", str(d)]), None),
    # ported since (A3): GPTQ calibrated on a text file, then greedy text
    "generate_gptq_calib": (lambda d: gptq_calib_runs(d), None),
    "load_and_prepare_tp": (lambda d: refuses_alone(
        lambda: generate.load_and_prepare(d, tp=2, device="cpu")), None),
    # ported since (A4 slice 1): each call runs and reads its delta back (None below)
    "generate_adapter": (lambda d: adapter_delta_runs(d, "adapter"), None),
    "generate_adapter_v2": (lambda d: adapter_delta_runs(d, "adapter_v2"), None),
    "chat_tp": (lambda d: refuses_alone(
        lambda: chat.main(checkpoint_dir=d, tp=2, device="cpu")), None),
    "server_speculative_k": (lambda d: speculative_server_runs(d), None),
    "server_tp": (lambda d: refuses_alone(
        lambda: server.main(checkpoint_dir=d, tp=2, device="cpu")), None),
    "server_fsdp": (lambda d: refuses_alone(
        lambda: server.main(checkpoint_dir=d, fsdp=2, device="cpu")), None),
    "bench_serving_speculative_k": (lambda d: "spec_acceptance" in bench_serving.run(
        checkpoint_dir=d, speculative_k=2, n_slots=2, n_requests=2, prompt_len=6,
        max_new_tokens=4, precision="float32", device="cpu"), None),
}


def refuses_alone(fn) -> bool:
    """A sharded entry point started without torchrun raises, naming the
    torchrun line to use: it never quietly serves on one rank."""
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m fastmax_tpu_torch"):
        fn()
    return True


def speculative_generate_runs(d: Path, flags: list) -> bool:
    """``generate.cli`` with speculative flags, sampled (the defaults' temperature
    0.8, top_k 200): it prints text."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        generate.cli(["--checkpoint_dir", str(d), "--max_new_tokens", "6", "--device", "cpu"]
                     + flags)
    return bool(out.getvalue().strip())


def speculative_server_runs(d: Path) -> bool:
    """``server.main --speculative_k 2`` builds its speculative batcher, serves,
    and stops at the interrupt that ends its wait."""
    import contextlib
    import io
    from unittest import mock

    made = []
    real_sleep = server.time.sleep

    def sleep(s):
        if s != 3600:  # the scheduler thread's idle wait
            return real_sleep(s)
        raise KeyboardInterrupt

    class Recording(server.Server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    with mock.patch.object(server, "Server", Recording), \
            mock.patch.object(server.time, "sleep", sleep), \
            contextlib.redirect_stdout(io.StringIO()):
        server.main(checkpoint_dir=d, host="127.0.0.1", port=0, n_slots=2, speculative_k=2,
                    precision="float32", device="cpu")
    return made[0].scheduler.batcher.speculative_k == 2 and \
        not made[0].scheduler._thread.is_alive()


def gptq_calib_runs(d: Path) -> bool:
    """``generate.main --gptq_calib`` on a text file, quantize gptq.int4:
    greedy text is printed (tests/test_torch_gptq_packed.py holds the tokens
    against the JAX package's)."""
    import contextlib
    import io

    calib = d / "calib.txt"
    calib.write_text(TEXT * 4)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        generate.main(prompt="hello", checkpoint_dir=d, gptq_calib=calib, quantize="gptq.int4",
                      max_new_tokens=4, temperature=0.0, precision="float32", device="cpu")
    return bool(out.getvalue().strip())


def adapter_delta_runs(d: Path, method: str) -> bool:
    """An adapter delta of the JAX package's layout for the directory's model
    (gates off zero, v2 scales off one), read back by ``apply_finetuned`` to
    the same leaves, and ``generate.main`` greedy on it."""
    import contextlib
    import io

    from fastmax_tpu.models import adapter as jadapter

    jcfg, jp = jckpt.load_model_params(d)
    v2 = method == "adapter_v2"
    tree = jadapter.add_adapter_params(jp, jcfg, jadapter.AdapterConfig(4, 1),
                                       jax.random.PRNGKey(2), v2=v2)
    delta = {n: np.asarray(a) + np.float32(0.25) for n, a in _flatten_delta(tree).items()
             if jadapter.adapter_filter_flat(n, v2)}
    path = d / f"{method}_delta.safetensors"
    jckpt.save_flat_checkpoint(delta, path)
    cfg, tp = load_model_params(d, device="cpu")
    back = generate.apply_finetuned(tp, cfg, path, method, torch.float32)
    flat = {}
    stack = [("", back)]
    while stack:
        prefix, node = stack.pop()
        for k, v in node.items():
            stack.append((f"{prefix}{k}.", v)) if isinstance(v, dict) else \
                flat.__setitem__(prefix + k, v)
    for n, a in delta.items():
        np.testing.assert_array_equal(flat[n].numpy(), a, err_msg=n)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        generate.main(prompt="ab", checkpoint_dir=d, method=method, finetuned_path=path,
                      max_new_tokens=4, temperature=0.0, precision="float32", device="cpu")
    return bool(out.getvalue().strip())


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_raise_with_their_item(ckpt, case):
    """Each unported flag raises with its ROADMAP item; a case ported since
    (item None) runs instead."""
    fn, item = UNPORTED[case]
    if item is None:
        assert fn(ckpt[0])
        return
    with pytest.raises(NotImplementedError, match=rf"\b{item}\b"):
        fn(ckpt[0])
