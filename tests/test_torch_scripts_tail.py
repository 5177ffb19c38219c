"""The last two scripts of the port against the JAX package on the CPU:
``scripts/prepare_openwebtext.py`` writes the JAX script's ``train.bin``,
``val.bin`` and ``meta.json`` bytes from a local ``.txt``, a ``.jsonl`` and
a directory of ``.txt`` files (a BPE tokenizer trained here, as
tests/test_inference_tools.py builds one), and pretraining's openwebtext
reader takes them; ``python -m fastmax_tpu_torch.native.build`` builds the
C++ packed loader; ``native_available()`` is True where ``g++`` exists; with
``g++`` hidden the packed reader falls back, with a warning, to
``PackedDataset``'s blocks, as the reference's does without its library, and
``pretrain --data_format packed`` still reads. ``scripts/download.py`` lists
the registry as the JAX script does, offline; with the Hub's
``snapshot_download`` replaced by a copy of a tiny HF checkpoint saved here
(no test touches the network), it fetches with the reference's patterns and
token, and converts what it fetched into the same checkpoint as
``convert_hf_checkpoint`` on those files, unless asked for the tokenizer
alone."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fastmax_tpu.data import packed_dataset as jpd
from fastmax_tpu.scripts import download as jdownload
from fastmax_tpu.scripts import prepare_openwebtext as jprep
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.native import build as tbuild
from fastmax_tpu_torch.native import loader as tloader
from fastmax_tpu_torch.scripts import convert_hf_checkpoint as tconv
from fastmax_tpu_torch.scripts import download as tdownload
from fastmax_tpu_torch.scripts import prepare_openwebtext as tprep
from fastmax_tpu_torch.training import pretrain
from fastmax_tpu_torch.utils.args import IOArgs
from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint
from tests.test_torch_inference_tools import write_tokenizer

REPO = Path(__file__).resolve().parents[1]
TEXTS = ("the quick brown fox jumps over the lazy dog", "hello world this is a tiny corpus",
         "tokenizers write ids and the script writes them to a memmap")


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    write_tokenizer(d, TEXTS, vocab_size=150)
    return d


def _sources(root: Path) -> dict:
    """One corpus in each local form the script reads."""
    root.mkdir(parents=True, exist_ok=True)
    txt = root / "corpus.txt"
    txt.write_text("\n".join(TEXTS * 30), encoding="utf-8")
    jsonl = root / "corpus.jsonl"
    with open(jsonl, "w", encoding="utf-8") as f:
        for i in range(40):
            f.write(json.dumps({"text": TEXTS[i % 3] + f" {i}"}) + "\n")
            if i % 7 == 0:
                f.write("\n")  # blank lines are skipped
        f.write(json.dumps({"text": ""}) + "\n")  # so are empty texts
    d = root / "dir"
    (d / "sub").mkdir(parents=True)
    for i, t in enumerate(TEXTS):
        (d / f"{i}.txt").write_text(t * (i + 5), encoding="utf-8")
    (d / "sub" / "z.txt").write_text(TEXTS[0], encoding="utf-8")
    (d / "skip.md").write_text("not read", encoding="utf-8")
    return {"txt": txt, "jsonl": jsonl, "dir": d}


@pytest.mark.parametrize("kind", ["txt", "jsonl", "dir"])
def test_prepare_openwebtext_writes_the_jax_bytes(tok_dir, tmp_path, kind, capsys):
    src = _sources(tmp_path / "src")[kind]
    jprep.prepare(str(src), tok_dir, tmp_path / "j", test_size=0.05)
    want = capsys.readouterr().out
    tprep.main([f"--source={src}", f"--checkpoint_dir={tok_dir}",
                f"--destination_path={tmp_path / 't'}", "--test_size=0.05"])
    assert capsys.readouterr().out == want.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    for name in ("train.bin", "val.bin", "meta.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    meta = json.loads((tmp_path / "t" / "meta.json").read_text())
    assert meta["dtype"] == "uint16"
    train = np.fromfile(tmp_path / "t" / "train.bin", np.uint16)
    val = np.fromfile(tmp_path / "t" / "val.bin", np.uint16)
    assert len(val) == max(int((len(train) + len(val)) * 0.05), 1)
    # pretraining's openwebtext reader takes the port's own output
    it, _ = pretrain.data_iterators("openwebtext", IOArgs(train_data_dir=tmp_path / "t"), 16, 2)
    batch = next(it)
    assert batch.shape == (2, 17) and int(batch.max()) < meta["vocab_size"]


def test_prepare_openwebtext_edges(tok_dir, tmp_path, monkeypatch):
    """test_size 0 keeps one validation token; a vocabulary of 65 500 or more
    writes int32 (the tokenizer's size patched on both sides)."""
    src = _sources(tmp_path / "src")["txt"]
    tprep.prepare(str(src), tok_dir, tmp_path / "zero", test_size=0.0)
    assert np.fromfile(tmp_path / "zero" / "val.bin", np.uint16).size == 1
    for mod in (jprep, tprep):
        big = type("Big", (mod.Tokenizer,), {"vocab_size": property(lambda self: 70000)})
        monkeypatch.setattr(mod, "Tokenizer", big)
    jprep.prepare(str(src), tok_dir, tmp_path / "j", test_size=0.1)
    tprep.prepare(str(src), tok_dir, tmp_path / "t", test_size=0.1)
    for name in ("train.bin", "val.bin", "meta.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert json.loads((tmp_path / "t" / "meta.json").read_text()) == {"dtype": "int32",
                                                                     "vocab_size": 70000}


@pytest.fixture
def chunks(tmp_path):
    writer = jpd.PackedDatasetBuilder(outdir=str(tmp_path / "chunks"), prefix="t",
                                      chunk_size=1024, sep_token=0, dtype=np.uint16,
                                      vocab_size=None)
    (tmp_path / "chunks").mkdir()
    rng = np.random.default_rng(0)
    for _ in range(10):
        writer.add_array(rng.integers(1, 60000, size=500).astype(np.uint16))
    writer.write_reminder()
    return sorted((tmp_path / "chunks").glob("*.bin"))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The loader building into an empty directory, with nothing loaded."""
    monkeypatch.setattr(tloader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tloader, "_LIB", None)
    return tmp_path / "_build"


def test_native_build_builds(fresh_build, capsys):
    path = tbuild.build()
    assert path.parent == fresh_build and path.is_file() and path == tloader.library_path()
    assert capsys.readouterr().out.strip() == f"built {path}"
    assert tloader.native_available()
    # the module's command line, into the package's own _build/
    out = subprocess.run([sys.executable, "-m", "fastmax_tpu_torch.native.build"], cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True).stdout
    built = Path(out.strip().split("built ", 1)[1])
    assert built.is_file() and built.parent == REPO / "fastmax_tpu_torch" / "_build"


def test_native_available_where_gxx_exists(chunks):
    import shutil

    assert shutil.which("g++") is not None
    assert tloader.native_available()
    ds = tloader.NativePackedDataset(chunks, 128, shuffle=False)
    blocks = list(ds)
    assert ds.reader == "native" and len(blocks) > 0


def test_without_gxx_the_reader_falls_back(chunks, fresh_build, tmp_path, monkeypatch):
    """g++ hidden from PATH and no library built: native_available() is
    False, the reader warns and gives PackedDataset's blocks (the JAX
    package's, over the same files), and pretraining's packed reader runs."""
    empty = tmp_path / "empty_path"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert not tloader.native_available()
    for shuffle in (False, True):
        ds = tloader.NativePackedDataset(chunks, 128, seed=9, shuffle=shuffle)
        with pytest.warns(RuntimeWarning, match="g\\+\\+ missing"):
            got = list(ds)
        want = list(jpd.PackedDataset(chunks, n_chunks=min(8, len(chunks)), block_size=128,
                                      seed=9, shuffle=shuffle))
        assert ds.reader == "numpy" and len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert not fresh_build.exists() or not list(fresh_build.glob("*.so"))
    with pytest.warns(RuntimeWarning):
        it, _ = pretrain.data_iterators("packed", IOArgs(train_data_dir=chunks[0].parent),
                                        127, 4)
        batch = next(it)
    assert batch.shape == (4, 128) and batch.dtype == np.int64
    assert os.environ["PATH"] == str(empty)


# ------------------------------------------------------------------ download


def test_download_lists_the_registry_as_the_jax_script(capsys):
    tdownload.main([])
    got = capsys.readouterr().out
    jdownload.download()
    assert got == capsys.readouterr().out
    assert got.splitlines() == ["Supported models:"] + [f"  {n}" for n in
                                                        tconfig_mod.available_models()]


HUB_LLAMA = dict(name="hub-llama", block_size=64, vocab_size=96, padded_vocab_size=96,
                 n_layer=2, n_head=4, n_embd=64, n_query_groups=2, intermediate_size=112,
                 rotary_percentage=1.0, parallel_residual=False, bias=False,
                 _norm_class="RMSNorm", _mlp_class="LLaMAMLP")


def write_hf_llama(d: Path, conf: dict) -> None:
    """A random Llama checkpoint in HF's names and layouts (``model.safetensors``,
    q/k/v apart, (out, in) weights), a config and a tokenizer file."""
    import torch
    from safetensors.torch import save_file

    rng = np.random.default_rng(5)
    c, i, v, hs = conf["n_embd"], conf["intermediate_size"], conf["vocab_size"], \
        conf["n_embd"] // conf["n_head"]
    shapes = {"model.embed_tokens.weight": (v, c), "model.norm.weight": (c,),
              "lm_head.weight": (v, c)}
    for layer in range(conf["n_layer"]):
        pre = f"model.layers.{layer}."
        shapes.update({
            pre + "input_layernorm.weight": (c,), pre + "post_attention_layernorm.weight": (c,),
            pre + "self_attn.q_proj.weight": (conf["n_head"] * hs, c),
            pre + "self_attn.k_proj.weight": (conf["n_query_groups"] * hs, c),
            pre + "self_attn.v_proj.weight": (conf["n_query_groups"] * hs, c),
            pre + "self_attn.o_proj.weight": (c, conf["n_head"] * hs),
            pre + "mlp.gate_proj.weight": (i, c), pre + "mlp.up_proj.weight": (i, c),
            pre + "mlp.down_proj.weight": (c, i)})
    d.mkdir(parents=True)
    save_file({n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for n, s in shapes.items()}, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({"model_type": "llama"}))
    (d / "tokenizer.json").write_text("{}")


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """``huggingface_hub.snapshot_download`` replaced by a copy, by the
    allowed patterns, of a tiny HF Llama written here, and the model
    registered under its repository's last name: (the written directory, the
    calls the fake got, the name)."""
    import fnmatch
    import shutil

    import huggingface_hub

    src = tmp_path / "hub"
    write_hf_llama(src, HUB_LLAMA)
    calls = []

    def snapshot_download(repo_id, local_dir, allow_patterns, token):
        calls.append(dict(repo_id=repo_id, local_dir=local_dir, allow_patterns=allow_patterns,
                          token=token))
        Path(local_dir).mkdir(parents=True)
        for f in src.iterdir():
            if any(fnmatch.fnmatch(f.name, pat) for pat in allow_patterns):
                shutil.copy(f, Path(local_dir) / f.name)
        return str(local_dir)

    monkeypatch.setattr(huggingface_hub, "snapshot_download", snapshot_download)
    reg = dict(tconfig_mod.registry(), **{HUB_LLAMA["name"]: dict(HUB_LLAMA)})
    monkeypatch.setattr(tconfig_mod, "registry", lambda: reg)
    return src, calls, HUB_LLAMA["name"]


def test_download_converts_what_it_fetched(hub, tmp_path, monkeypatch):
    src, calls, name = hub
    monkeypatch.setenv("HF_TOKEN", "hf_from_the_environment")
    tdownload.main(["--repo_id", f"org/{name}", "--checkpoint_dir", str(tmp_path / "ck")])
    d = tmp_path / "ck" / "org" / name
    assert calls == [dict(repo_id=f"org/{name}", local_dir=d, token="hf_from_the_environment",
                          allow_patterns=["*.safetensors*", "*.bin*", "*.json", "tokenizer*"])]
    ref = tconv.convert_hf_checkpoint(src, model_name=name, out_dir=tmp_path / "ref")
    got, want = load_flat_checkpoint(d), load_flat_checkpoint(ref)
    assert sorted(got) == sorted(want) and "lm_head.weight" in got
    for n, w in want.items():
        np.testing.assert_array_equal(got[n].numpy(), w.numpy(), err_msg=n)
    assert json.loads((d / "lit_config.json").read_text()) == \
        json.loads((ref / "lit_config.json").read_text())
    assert (d / "tokenizer.json").exists()


def test_download_tokenizer_only_skips_the_conversion(hub, tmp_path):
    src, calls, name = hub
    tdownload.download(repo_id=f"org/{name}", checkpoint_dir=tmp_path / "ck",
                       access_token="hf_given", tokenizer_only=True)
    d = tmp_path / "ck" / "org" / name
    assert calls[0]["allow_patterns"] == ["tokenizer*", "generation_config.json"]
    assert calls[0]["token"] == "hf_given"
    names = sorted(p.name for p in d.iterdir())
    assert "tokenizer.json" in names and "lit_config.json" not in names
    assert not any(n.endswith((".safetensors", ".bin")) for n in names)
