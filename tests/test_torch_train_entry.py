"""The port's training entry points over this slice's modules against the
JAX package on the CPU: ``pretrain.setup(data_format="packed")`` (the C++
reader of ``native/``, a TensorBoard log), ``finetune.setup(gptq_calib=True)``
and ``generate --gptq_calib`` (``ops/gptq.py``, tests/test_torch_gptq_packed.py).

Models: the 2-layer 128-wide GQA LLaMA of tests/test_quant_pallas.py:120-123
(n_head=4, n_query_groups=2), in float32. Tolerances: the first logged loss
of a run at rtol 1e-4 (as tests/test_torch_cli.py holds its runs); greedy
text exactly.
"""

import csv
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.native import loader as jloader
from fastmax_tpu.training import finetune as jfinetune
from fastmax_tpu.training import pretrain as jpretrain
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu.utils.args import EvalArgs as JEvalArgs
from fastmax_tpu.utils.args import IOArgs as JIOArgs
from fastmax_tpu.utils.args import TrainArgs as JTrainArgs
from fastmax_tpu_torch.data import packed_dataset as tpd
from fastmax_tpu_torch.inference import generate
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.native import loader as tloader
from fastmax_tpu_torch.training import finetune, pretrain
from fastmax_tpu_torch.utils.args import EvalArgs, IOArgs, TrainArgs

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
LLAMA = dict(name="entry-tiny-llama", block_size=64, vocab_size=128, padded_vocab_size=128,
             n_layer=2, n_head=4, n_embd=128, n_query_groups=2, intermediate_size=256,
             _norm_class="RMSNorm", _mlp_class="LLaMAMLP", bias=False, rotary_percentage=1.0,
             parallel_residual=False)
TEXT = "hello world this is a tiny tokenizer for the packed data and the gptq tools"


def jax_tree(cfg_kw, seed=0):
    jcfg = JaxConfig(**cfg_kw)
    return jcfg, jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(seed),
                                                           jnp.float32))


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


@pytest.fixture
def registries(monkeypatch):
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg[LLAMA["name"]] = dict(LLAMA)
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)


def logged(out: Path, key: str = "loss") -> list:
    with open(out / "metrics.csv", newline="") as f:
        return [float(r[key]) for r in csv.DictReader(f) if r.get(key)]


def test_pretrain_on_packed_data(tmp_path, registries, monkeypatch):
    """The numpy reader on both sides (the JAX package's fallback, the port's
    native=False) and the JAX package's initial weights give the JAX loss;
    the port's native reader trains, logging to TensorBoard."""
    data = tmp_path / "data"
    builder = tpd.PackedDatasetBuilder(str(data), "train", chunk_size=65 * 16, sep_token=0,
                                       dtype=np.uint16)
    data.mkdir()
    builder.add_array((np.arange(65 * 16 * 4) % 11 + 3).astype(np.uint16))
    builder.write_reminder()
    common = dict(model_name=LLAMA["name"], data_format="packed")
    train = dict(global_batch_size=2, micro_batch_size=2, max_iters=2, learning_rate=3e-3,
                 lr_warmup_steps=1, log_interval=1)
    monkeypatch.setattr(jloader, "native_available", lambda: False)
    jpretrain.setup(train=JTrainArgs(**train), eval=JEvalArgs(interval=1000, max_iters=1),
                    io=JIOArgs(train_data_dir=data, out_dir=tmp_path / "j"), **common)
    numpy_reader = functools.partial(tloader.NativePackedDataset, native=False)
    _, jp = jax_tree(LLAMA, seed=1337)  # the JAX package's init for setup's seed
    with monkeypatch.context() as m:
        m.setattr(pretrain, "NativePackedDataset", numpy_reader)
        m.setattr(pretrain.gpt, "init_params",
                  lambda cfg, seed, dtype, device: from_numpy_params(jp, device))
        pretrain.setup(train=TrainArgs(**train), eval=EvalArgs(interval=1000, max_iters=1),
                       io=IOArgs(train_data_dir=data, out_dir=tmp_path / "t"), device="cpu",
                       **common)
    np.testing.assert_allclose(logged(tmp_path / "t")[0], logged(tmp_path / "j")[0], rtol=1e-4)
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # tensorboard's stub, not TF's import
    state = pretrain.setup(train=TrainArgs(**{**train, "max_iters": 4}),
                           eval=EvalArgs(interval=1000, max_iters=1),
                           io=IOArgs(train_data_dir=data, out_dir=tmp_path / "n"), device="cpu",
                           logger_name="tensorboard", **common)
    assert state.step == 4 and list((tmp_path / "n" / "tb").glob("events.out.tfevents.*"))


def sft_npz(path: Path) -> Path:
    rng = np.random.default_rng(1)
    examples = []
    for _ in range(8):
        x = rng.integers(3, 128, int(rng.integers(40, 64))).astype(np.int64)
        y = x.copy()
        y[: len(x) // 4] = -1
        examples.append({"input_ids": x, "labels": y})
    np.savez(path, examples=np.array(examples, dtype=object))
    return path


def jax_written_dir(root: Path, with_tokenizer: bool = False) -> Path:
    """The tiny LLaMA (the JAX package's init), written by the JAX package."""
    d = root / "ckpt"
    kw = dict(LLAMA)
    if with_tokenizer:
        vocab = write_tokenizer(d)
        kw.update(vocab_size=vocab, padded_vocab_size=vocab)
    jcfg, jp = jax_tree(kw)
    jckpt.save_flat_checkpoint(jparams.params_to_flat(jp, jcfg), d)
    jcfg.to_json(d / "lit_config.json")
    return d


def test_finetune_with_gptq_calib_matches_jax(tmp_path):
    """The GPTQ-quantized base calibrated on the training data: the first
    loss of a QLoRA step (lora_B is zero at init) is the JAX package's."""
    ckpt, data = jax_written_dir(tmp_path), sft_npz(tmp_path / "sft.npz")
    kw = dict(method="lora", checkpoint_dir=ckpt, data_path=data, quantize="gptq.int4",
              gptq_calib=True, precision="float32")
    train = dict(global_batch_size=2, micro_batch_size=2, max_iters=1, log_interval=1,
                 max_seq_length=64, lr_warmup_steps=0)
    jfinetune.setup(**kw, train=JTrainArgs(**train), io=JIOArgs(out_dir=tmp_path / "j"))
    state = finetune.setup(**kw, train=TrainArgs(**train), io=IOArgs(out_dir=tmp_path / "t"),
                           device="cpu")
    assert state.step == 1
    np.testing.assert_allclose(logged(tmp_path / "t")[0], logged(tmp_path / "j")[0], rtol=1e-4)


def test_generate_with_gptq_calib_prints_the_jax_text(tmp_path, capsys):
    d = jax_written_dir(tmp_path, with_tokenizer=True)
    calib = tmp_path / "calib.txt"
    calib.write_text((TEXT + " ") * 6)
    kw = dict(checkpoint_dir=d, prompt="hello world", max_new_tokens=8, temperature=0.0,
              precision="float32", quantize="gptq.int4", gptq_calib=calib,
              weights_mode="quantized")
    jgenerate.main(**kw)
    want = capsys.readouterr().out
    generate.cli([f"--{k}={v}" for k, v in kw.items()] + ["--device", "cpu"])
    assert capsys.readouterr().out == want and "hello world" in want
