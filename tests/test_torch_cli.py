"""The port's command lines against the JAX package on the CPU: utils/cli.py,
``finetune.main`` (with ``--checkpoint_dir`` and ``--method full``) and
``pretrain.main`` (with its ``out_dir/final`` checkpoint); the signatures of
every ported command line against the reference's, and every main that
computes defaulting to the card.

Every ``launch_scripts/pretrain_*.sh`` and ``finetune_*.sh`` command (its
``exec`` wrappers followed, its shell variables substituted, ``NCHIPS=1``:
``chip_smoke.launch_command``, which phase 12 runs on the card) parses to the
same keyword arguments in both packages. Both packages finetune a tiny LLaMA
from the same JAX-written directory on the same data: the first logged loss
agrees to 1e-4 relative (float32; a LoRA run's lora_B is zero at init, so that
loss depends only on the loaded base, its NF4 codes and the data order, each
held equal elsewhere). The checkpoints each package writes (``full_weights``,
pretraining's ``out_dir/final``) read in the other bit for bit.
"""

import csv
import dataclasses
import functools
import gzip
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import launch_command
from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.eval import harness as jharness
from fastmax_tpu.inference import bench_serving as jbench
from fastmax_tpu.inference import chat as jchat
from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.inference import server as jserver
from fastmax_tpu.scripts import convert_hf_checkpoint as jconv
from fastmax_tpu.scripts import convert_lit_checkpoint as jlit
from fastmax_tpu.scripts import convert_pretrained_checkpoint as jpre
from fastmax_tpu.scripts import merge_lora as jmerge
from fastmax_tpu.scripts import prepare_alpaca as jprep
from fastmax_tpu.scripts import prepare_openwebtext as jprep_owt
from fastmax_tpu.scripts import prepare_packed as jprep_packed
from fastmax_tpu.training import bench_mfu as jbench_mfu
from fastmax_tpu.training import finetune as jfinetune
from fastmax_tpu.training import pretrain as jpretrain
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu.utils import cli as jcli
from fastmax_tpu_torch.eval import harness
from fastmax_tpu_torch.inference import bench_serving, chat, generate, server
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models.params import flat_to_params
from fastmax_tpu_torch.models.weights import to_numpy_params
from fastmax_tpu_torch.scripts import convert_hf_checkpoint as tconv
from fastmax_tpu_torch.scripts import convert_lit_checkpoint as tlit
from fastmax_tpu_torch.scripts import convert_pretrained_checkpoint as tpre
from fastmax_tpu_torch.scripts import merge_lora as tmerge
from fastmax_tpu_torch.scripts import prepare_alpaca as tprep
from fastmax_tpu_torch.scripts import prepare_openwebtext as tprep_owt
from fastmax_tpu_torch.scripts import prepare_packed as tprep_packed
from fastmax_tpu_torch.training import bench_mfu, finetune, pretrain
from fastmax_tpu_torch.utils import cli
from fastmax_tpu_torch.utils.args import TrainArgs
from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint, load_model_params

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
SCRIPTS = sorted(p.name for p in (REPO / "launch_scripts").glob("*.sh")
                 if p.name.startswith(("pretrain_", "finetune_")))
TINY_LLAMA = dict(name="cli-tiny-llama", block_size=256, vocab_size=256, padded_vocab_size=256,
                  n_layer=2, n_head=4, n_embd=64, n_query_groups=2, intermediate_size=128,
                  _norm_class="RMSNorm", _mlp_class="LLaMAMLP", bias=False,
                  rotary_percentage=1.0, parallel_residual=False, attn_alg="quadratic")
TINY_FASTMAX = dict(name="cli-tiny-fastmax", scale_embeddings=True, block_size=32, vocab_size=64,
                    padded_vocab_size=64, n_layer=2, n_head=2, n_embd=64, attn_alg="fastmax_cuda")


def plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def jax_kwargs(fn, flags: list) -> dict:
    """The keyword arguments the JAX package's CLI would call ``fn`` with."""
    return jcli.CLI(functools.wraps(fn)(lambda **kw: kw), flags)


# ------------------------------------------------------------------ launch scripts


def test_launch_scripts_are_found():
    assert len(SCRIPTS) == 20, SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_launch_script_parses_like_jax(script):
    module, flags = launch_command(script, ["checkpoints/meta-llama/Llama-2-7b-hf",
                                            "data/alpaca/train.npz"])
    assert module in ("fastmax_tpu.training.finetune", "fastmax_tpu.training.pretrain")
    jmod, tmod = ((jfinetune, finetune) if module.endswith("finetune") else (jpretrain, pretrain))
    want = jax_kwargs(jmod.setup, flags)
    got = cli.parse_kwargs(tmod.setup, flags)
    assert set(got) == set(want) | {"device"} and got["device"] is None
    for k, v in want.items():
        assert plain(got[k]) == plain(v), (script, k)
    assert isinstance(got["train"], TrainArgs)
    if script.startswith("finetune_"):
        assert got["checkpoint_dir"] == Path("checkpoints/meta-llama/Llama-2-7b-hf")


# (JAX function, port function, the flags its required parameters need)
SIGNATURES = {
    "finetune": (jfinetune.setup, finetune.setup, []),
    "pretrain": (jpretrain.setup, pretrain.setup, []),
    "convert_hf_checkpoint": (jconv.convert_hf_checkpoint, tconv.convert_hf_checkpoint,
                              ["--checkpoint_dir", "x"]),
    "generate": (jgenerate.main, generate.main, []),
    "load_and_prepare": (jgenerate.load_and_prepare, generate.load_and_prepare, None),
    "chat": (jchat.main, chat.main, []),
    "server": (jserver.main, server.main, []),
    "bench_serving": (jbench.run, bench_serving.run, []),
    "eval_harness": (jharness.run_eval_harness, harness.run_eval_harness,
                     ["--checkpoint_dir", "x"]),
    "merge_lora": (jmerge.merge_lora, tmerge.merge_lora,
                   ["--checkpoint_dir", "x", "--lora_path", "y"]),
    "convert_lit_checkpoint": (jlit.convert_lit_checkpoint, tlit.convert_lit_checkpoint,
                               ["--checkpoint_path", "x", "--output_path", "y"]),
    "convert_pretrained_checkpoint": (jpre.convert_pretrained_checkpoint,
                                      tpre.convert_pretrained_checkpoint,
                                      ["--checkpoint_dir", "x", "--output_dir", "y"]),
    "prepare_alpaca": (jprep.prepare, tprep.prepare,
                       ["--data_file", "x", "--checkpoint_dir", "y"]),
    "prepare_packed": (jprep_packed.prepare, tprep_packed.prepare,
                       ["--source_path", "x", "--checkpoint_dir", "y"]),
    "bench_mfu": (jbench_mfu.run, bench_mfu.run, []),
    "prepare_openwebtext": (jprep_owt.prepare, tprep_owt.prepare,
                            ["--source", "x", "--checkpoint_dir", "y"]),
}


@pytest.mark.parametrize("pair", list(SIGNATURES))
def test_setup_signatures_hold_the_reference(pair):
    jfn, tfn, required = SIGNATURES[pair]
    want = inspect.signature(jfn).parameters
    got = inspect.signature(tfn).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert plain(got[name].default) == plain(p.default), name
        assert got[name].kind == p.kind, name
    assert set(got) - set(want) <= {"device"}
    if required is None:  # not a command line
        return
    kw = cli.parse_kwargs(tfn, required)
    for name, p in got.items():
        if p.default is not inspect.Parameter.empty:
            assert plain(kw[name]) == plain(p.default), name


def test_cli_types_and_required_flags():
    def fn(a: int, b: float = 0.5, c: bool = False, d=None, e: TrainArgs = TrainArgs()):
        return a

    kw = cli.parse_kwargs(fn, ["--a", "3", "--c", "true", "--d", "x", "--e.max_iters", "7",
                               "--e.max_seq_length", "9"])
    assert kw["a"] == 3 and kw["b"] == 0.5 and kw["c"] is True and kw["d"] == "x"
    assert kw["e"] == TrainArgs(max_iters=7, max_seq_length=9)
    assert cli.CLI(fn, ["--a", "4"]) == 4
    with pytest.raises(SystemExit):
        cli.parse_kwargs(fn, [])


# ------------------------------------------------------------------ finetuning


@pytest.fixture
def registries(monkeypatch):
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg[TINY_FASTMAX["name"]] = dict(TINY_FASTMAX)
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)


def jax_written_dir(root: Path) -> Path:
    """The tiny LLaMA drawn with numpy, written by the JAX package."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jgpt.init_params(JaxConfig(**TINY_LLAMA),
                                                     jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.05, shapes)
    d = root / "ckpt"
    jckpt.save_flat_checkpoint(jparams.params_to_flat(tree, JaxConfig(**TINY_LLAMA)), d)
    JaxConfig(**TINY_LLAMA).to_json(d / "lit_config.json")
    return d


def sft_npz(path: Path) -> Path:
    rng = np.random.default_rng(1)
    examples = []
    for _ in range(8):
        x = rng.integers(3, 256, int(rng.integers(40, 120))).astype(np.int64)
        y = x.copy()
        y[: len(x) // 4] = -1
        examples.append({"input_ids": x, "labels": y})
    np.savez(path, examples=np.array(examples, dtype=object))
    return path


def logged(out: Path, key: str = "loss") -> list:
    with open(out / "metrics.csv", newline="") as f:
        return [float(r[key]) for r in csv.DictReader(f) if r.get(key)]


@pytest.mark.parametrize("method", ["lora", "full"])
def test_finetune_main_from_a_jax_directory_matches_jax(tmp_path, method):
    ckpt, data = jax_written_dir(tmp_path), sft_npz(tmp_path / "sft.npz")
    flags = ["--method", method, "--checkpoint_dir", str(ckpt), "--data_path", str(data),
             "--precision", "float32", "--train.global_batch_size", "2",
             "--train.micro_batch_size", "2", "--train.max_iters", "1",
             "--train.log_interval", "1", "--train.max_seq_length", "128",
             "--train.lr_warmup_steps", "0"]  # the first step's learning rate is then not 0
    if method == "lora":
        flags += ["--quantize", "bnb.nf4"]
    jcli.CLI(jfinetune.setup, flags + ["--io.out_dir", str(tmp_path / "j")])
    state = finetune.main(flags + ["--io.out_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert state.step == 1
    jloss, tloss = logged(tmp_path / "j"), logged(tmp_path / "t")
    assert len(jloss) == len(tloss) == 1
    np.testing.assert_allclose(tloss[0], jloss[0], rtol=1e-4)

    f = f"{method}_weights.safetensors"
    from safetensors.numpy import load_file

    want, got = load_file(str(tmp_path / "j" / f)), load_flat_checkpoint(tmp_path / "t" / f)
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert tuple(got[n].shape) == w.shape and str(got[n].dtype)[6:] == str(w.dtype), n
    if method == "full":  # every lit name of the input, and the run's own final weights
        assert sorted(got) == sorted(jckpt.load_flat_checkpoint(ckpt))
        cfg = tconfig_mod.Config.from_checkpoint(ckpt)
        back = to_numpy_params(flat_to_params(got, cfg, torch.float32, "cpu"))
        final = to_numpy_params(state.params)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(final)[0],
                                jax.tree.leaves(back)):
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        assert not np.array_equal(final["blocks"]["mlp"]["proj"]["kernel"],
                                  load_model_params(ckpt, device="cpu")[1]["blocks"]["mlp"]
                                  ["proj"]["kernel"].numpy())


def test_setup_takes_the_adapter_flags_and_still_refuses_them(tmp_path):
    """The adapter flags parse and now run: one adapter_v2 step from a JAX-written
    directory on an NF4 base gives the JAX command's loss and delta names; --dp
    (A8, on a mesh since: tests/test_torch_train_mesh.py) started alone is
    refused with the torchrun line (gptq_calib runs: tests/test_torch_gptq_packed.py)."""
    flags = ["--method", "adapter_v2", "--adapter_prompt_length", "4",
             "--adapter_start_layer", "1"]
    kw = cli.parse_kwargs(finetune.setup, flags)
    assert kw["adapter_prompt_length"] == 4 and kw["adapter_start_layer"] == 1
    ckpt, data = jax_written_dir(tmp_path), sft_npz(tmp_path / "sft.npz")
    flags += ["--checkpoint_dir", str(ckpt), "--data_path", str(data), "--precision", "float32",
              "--quantize", "bnb.nf4", "--train.global_batch_size", "2",
              "--train.micro_batch_size", "2", "--train.max_iters", "1",
              "--train.log_interval", "1", "--train.max_seq_length", "128"]
    jcli.CLI(jfinetune.setup, flags + ["--io.out_dir", str(tmp_path / "j")])
    state = finetune.main(flags + ["--io.out_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert state.step == 1
    np.testing.assert_allclose(logged(tmp_path / "t")[0], logged(tmp_path / "j")[0], rtol=1e-4)
    from safetensors.numpy import load_file

    f = "adapter_v2_weights.safetensors"
    assert sorted(load_flat_checkpoint(tmp_path / "t" / f)) == \
        sorted(load_file(str(tmp_path / "j" / f)))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m "
                       "fastmax_tpu_torch.training.finetune"):  # --gptq_calib runs since (A3)
        finetune.main(flags + ["--dp", "2", "--io.out_dir", str(tmp_path / "x"), "--device",
                               "cpu"])


# ------------------------------------------------------------------ pretraining


def enwik8_gz(path: Path) -> Path:
    path.write_bytes(gzip.compress(np.random.default_rng(2).integers(0, 64, 20_000)
                                   .astype(np.uint8).tobytes()))
    return path


def test_pretrain_main_writes_the_final_checkpoint_like_jax(tmp_path, registries):
    data = enwik8_gz(tmp_path / "enwik8.gz")
    flags = ["--model_name", TINY_FASTMAX["name"], "--data_format", "enwik8",
             "--io.train_data_dir", str(data), "--train.micro_batch_size", "2",
             "--train.global_batch_size", "2", "--train.max_iters", "2",
             "--train.log_interval", "1", "--eval.interval", "1000"]
    state = pretrain.main(flags + ["--io.out_dir", str(tmp_path / "t"), "--device", "cpu"])
    final = tmp_path / "t" / "final"
    assert state.step == 2 and (final / "lit_config.json").is_file()
    assert tconfig_mod.Config.from_checkpoint(final) == tconfig_mod.Config.from_name(
        TINY_FASTMAX["name"])
    jcfg, jtree = jckpt.load_model_params(final)
    want = to_numpy_params(state.params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))

    jcli.CLI(jpretrain.setup, flags + ["--io.out_dir", str(tmp_path / "j")])
    _, jtree = jckpt.load_model_params(tmp_path / "j" / "final")
    cfg, ttree = load_model_params(tmp_path / "j" / "final", device="cpu")
    assert cfg.name == TINY_FASTMAX["name"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                            jax.tree.leaves(to_numpy_params(ttree))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))


# ------------------------------------------------------------------ defaults


def test_mains_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.main(["--model_name", "Llama-2-7b-hf", "--data_path", "unused.npz",
                       "--io.out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.main(["--model_name", "easy-transformer-fastmax", "--io.out_dir",
                       str(tmp_path)])
    # the inference and eval command lines: the card is asked for before anything is read
    for main_fn in (generate.cli, chat.cli, server.cli, harness.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main_fn(["--checkpoint_dir", str(tmp_path / "absent")])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serving.main(["--model_name", "pythia-14m"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_mfu.main(["--model_name", "pythia-14m"])
    # prepare_packed uses no device: it goes on to read the checkpoint's tokenizer
    with pytest.raises(NotADirectoryError):
        tprep_packed.main(["--source_path", str(tmp_path), "--checkpoint_dir",
                           str(tmp_path / "absent"), "--destination_path", str(tmp_path / "p")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmerge.main(["--checkpoint_dir", str(tmp_path), "--lora_path", "unused.safetensors"])
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    for module, flags in (("training.pretrain", ["--model_name", "easy-transformer",
                                                 "--io.out_dir", str(tmp_path)]),
                          ("training.finetune", ["--model_name", "easy-transformer",
                                                 "--io.out_dir", str(tmp_path)]),
                          ("inference.generate", ["--checkpoint_dir", str(tmp_path)])):
        out = subprocess.run([sys.executable, "-m", f"fastmax_tpu_torch.{module}", *flags],
                             capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
        assert out.returncode != 0 and "CUDA" in out.stderr, (module, out.stderr[-2000:])
