"""The rest of training in the port against the JAX package on the CPU:
``ops/gptq.py``, ``data/packed_dataset.py``, the C++ loader of ``native/``,
``scripts/prepare_packed.py``, the TensorBoard and W&B loggers and
``training/bench_mfu.py``. The entry points that use them
(``pretrain --data_format packed``, ``finetune --gptq_calib``,
``generate --gptq_calib``) are held in tests/test_torch_train_entry.py.

Models: the 2-layer 128-wide GQA LLaMA of tests/test_quant_pallas.py:120-123
(n_head=4, n_query_groups=2) and a GPT-NeoX of the same size. Tolerances:
GPTQ codes exactly (float64 in both), except a code whose scaled weight the
port rounded within NEAR_TIE (1e-5) of a code midpoint, which is reported
with its distance, and absmax and the double-quant scales at rtol 1e-6
(float32 results of float64 sums in other orders); packed files byte for byte and blocks exactly;
bench_mfu's bf16 loss after two steps at rtol 2e-2 (the bf16 updates
round in each library's own order).
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

from fastmax_tpu.data import packed_dataset as jpd
from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import gptq as jgptq
from fastmax_tpu.scripts import prepare_packed as jprep
from fastmax_tpu.training import bench_mfu as jbench
from fastmax_tpu_torch.data import packed_dataset as tpd
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.native import loader as tloader
from fastmax_tpu_torch.ops import gptq, quant
from fastmax_tpu_torch.scripts import prepare_packed as tprep
from fastmax_tpu_torch.training import bench_mfu
from fastmax_tpu_torch.utils import logging as tlogging

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
LLAMA = dict(name="gp-tiny-llama", block_size=64, vocab_size=128, padded_vocab_size=128,
             n_layer=2, n_head=4, n_embd=128, n_query_groups=2, intermediate_size=256,
             _norm_class="RMSNorm", _mlp_class="LLaMAMLP", bias=False, rotary_percentage=1.0,
             parallel_residual=False)
NEOX = dict(name="gp-tiny-neox", block_size=64, vocab_size=128, padded_vocab_size=128,
            n_layer=2, n_head=4, n_embd=128, intermediate_size=256, rotary_percentage=0.25,
            parallel_residual=True, bias=True)
TEXT = "hello world this is a tiny tokenizer for the packed data and the gptq tools"
# a code may differ from the JAX package's only where the port's scaled weight lay
# this close to a code midpoint: the layers' float32 activations, computed by two
# libraries, differ in their last bits, and so do the Hessians they give
NEAR_TIE = 1e-5


def jax_tree(cfg_kw, seed=0):
    jcfg = JaxConfig(**cfg_kw)
    return jcfg, jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(seed),
                                                           jnp.float32))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else
                   {name: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)})
    return out


@pytest.fixture
def column_distances(monkeypatch):
    """One (in, out) array a kernel the port's GPTQ quantizes, in call order:
    each scaled weight's distance to the nearest code midpoint when its
    column was rounded."""
    kernels, current = [], []
    column, kernel_fn = gptq._quantize_column, gptq.gptq_quantize_kernel

    def spy_column(w, scale, code, mids):
        safe = torch.where(scale == 0, torch.ones_like(scale), scale)
        current.append((w / safe)[:, None].sub(mids[None, :]).abs().amin(dim=1).numpy())
        return column(w, scale, code, mids)

    def spy_kernel(*a, **kw):
        current.clear()
        out = kernel_fn(*a, **kw)
        kernels.append(np.stack(current))
        return out

    monkeypatch.setattr(gptq, "_quantize_column", spy_column)
    monkeypatch.setattr(gptq, "gptq_quantize_kernel", spy_kernel)
    return kernels


def unpack(q4: np.ndarray) -> np.ndarray:
    """(in/2, out) packed bytes -> (in, out) codes, the high nibble first."""
    return np.stack([q4 >> 4, q4 & 0xF], axis=1).reshape(-1, q4.shape[-1])


def absmax_of(p: dict, n_groups: int) -> np.ndarray:
    if "absmax" in p:
        return p["absmax"]
    out = p["q4"].shape[-1]
    flat = (p["absmax_q"].astype(np.float32) * p["absmax_scale"][:, None]).reshape(-1)
    return (flat[:n_groups * out] + p["absmax_offset"]).reshape(n_groups, out)


def assert_linear_equal(got: dict, want: dict, dist: np.ndarray, report: list, name: str):
    """Codes exactly, absmax at rtol 1e-6, except where the port rounded a
    weight within NEAR_TIE of a code midpoint to the other side: then that
    output channel's later columns follow another error feedback (GPTQ's
    update of a column's error stays in its channel), and the channel is
    held up to that column's group."""
    assert sorted(got) == sorted(want), name
    for leaf, a in want.items():
        assert got[leaf].shape == a.shape and got[leaf].dtype == a.dtype, (name, leaf)
    np.testing.assert_array_equal(got["code"], want["code"])
    cw, cg = unpack(want["q4"]), unpack(got["q4"])
    diff = cw != cg
    n_groups = cw.shape[0] // quant.DEFAULT_BLOCK
    held = np.ones((n_groups, cw.shape[1]), bool)
    for c in np.flatnonzero(diff.any(axis=0)):
        i0 = int(np.argmax(diff[:, c]))
        report.append((name, int(i0), int(c), float(dist[i0, c])))
        assert dist[i0, c] < NEAR_TIE, (name, i0, c, dist[i0, c])
        held[i0 // quant.DEFAULT_BLOCK + 1:, c] = False
    assert diff.any(axis=0).mean() <= 0.02, (name, int(diff.any(axis=0).sum()))
    if "absmax" in want or held.all():
        for leaf in ("absmax", "absmax_scale", "absmax_offset"):
            if leaf in want:
                np.testing.assert_allclose(got[leaf][held] if leaf == "absmax" else got[leaf],
                                           want[leaf][held] if leaf == "absmax" else want[leaf],
                                           rtol=1e-6, err_msg=f"{name}.{leaf}")
        if "absmax_q" in want and held.all():
            np.testing.assert_array_equal(got["absmax_q"], want["absmax_q"])
    else:  # a moved channel moves the mean the double quantization removes: one int8 step
        np.testing.assert_allclose(absmax_of(got, n_groups)[held],
                                   absmax_of(want, n_groups)[held], rtol=0,
                                   atol=float(np.max(want["absmax_scale"])) * 1.01)


def report_ties(report: list, dists: list) -> None:
    nearest = min(float(d.min()) for d in dists)
    print(f"nearest approach to a code midpoint: {nearest:.3e}; codes that differ from the JAX "
          f"package's (name, column, channel, distance): {report}")


@pytest.mark.parametrize("kind,dq", [("int4", False), ("nf4", False), ("nf4", True),
                                     ("fp4", True)])
def test_gptq_kernel_matches_jax(kind, dq, column_distances):
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    x = rng.standard_normal((300, 256)) @ rng.standard_normal((256, 256)) * 0.1
    x[:, 7] = 0.0  # a dead input: its weights are zeroed, its Hessian diagonal set to 1
    want = jgptq.gptq_quantize_kernel(kernel, jgptq.hessian(x), kind=kind, double_quant=dq)
    got = gptq.gptq_quantize_kernel(torch.from_numpy(kernel), gptq.hessian(torch.from_numpy(x)),
                                    kind=kind, double_quant=dq)
    report = []
    assert_linear_equal(flat(got), flat(want), column_distances[0], report, kind)
    report_ties(report, column_distances)
    # the 4-bit kernels take the packed codes and scales as contiguous (in/2, out) rows
    assert all(t.is_contiguous() for t in got.values())


def test_gptq_with_an_identity_hessian_is_round_to_nearest():
    kernel = torch.from_numpy(np.random.default_rng(4).standard_normal((128, 64))
                              .astype(np.float32))
    for kind in ("int4", "nf4"):
        got = gptq.gptq_quantize_kernel(kernel, torch.eye(128, dtype=torch.float64), kind=kind)
        want = quant.quantize_4bit(kernel, kind=kind)
        assert torch.equal(got["q4"], want["q4"]) and torch.equal(got["absmax"], want["absmax"])


@pytest.mark.parametrize("family,dq", [("llama", False), ("llama", True), ("neox", False),
                                       ("neox", True)])
def test_gptq_model_matches_jax(family, dq, column_distances):
    """Every block linear, layer by layer, in the order the port quantizes
    them; the leaves outside the blocks unchanged."""
    kw = {k: v for k, v in (LLAMA if family == "llama" else NEOX).items() if k != "name"}
    jcfg, jp = jax_tree(kw)
    calib = np.random.default_rng(5).integers(0, 128, (2, 48)).astype(np.int32)
    kind = "int4" if family == "llama" else "nf4"
    want = flat(jax.tree.map(np.asarray, jgptq.gptq_quantize_model(jp, jcfg, calib, kind=kind,
                                                                   double_quant=dq)))
    got = flat(gptq.gptq_quantize_model(from_numpy_params(jp, "cpu"), Config(**kw), calib,
                                        kind=kind, double_quant=dq, device="cpu"))
    assert sorted(got) == sorted(want)
    order = ("attn.attn", "attn.proj") + (("mlp.fc_1", "mlp.fc_2", "mlp.proj")
                                          if family == "llama" else ("mlp.fc", "mlp.proj"))
    assert len(column_distances) == jcfg.n_layer * len(order)
    report = []
    for layer in range(jcfg.n_layer):
        for i, name in enumerate(order):
            prefix = f"blocks.{name}."
            pick = lambda tree: {k[len(prefix):]: v[layer] for k, v in tree.items()  # noqa: E731
                                 if k.startswith(prefix) and k[len(prefix):] != "bias"}
            assert_linear_equal(pick(got), pick(want),
                                column_distances[layer * len(order) + i], report,
                                f"{layer}.{name}")
    for k, a in want.items():
        if not any(k.startswith(f"blocks.{n}.") and not k.endswith(".bias") for n in order):
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    report_ties(report, column_distances)


# ------------------------------------------------------------------ packed data


def write_chunks(builder_mod, outdir: Path, seed: int = 0) -> list:
    outdir.mkdir(parents=True, exist_ok=True)
    builder = builder_mod.PackedDatasetBuilder(outdir=str(outdir), prefix="t", chunk_size=1024,
                                               sep_token=0, dtype=np.uint16, vocab_size=None)
    rng = np.random.default_rng(seed)
    for _ in range(10):
        builder.add_array(rng.integers(1, 60000, size=500).astype(np.uint16))
    builder.write_reminder()
    return sorted(outdir.glob("*.bin"))


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """The same arrays written by each package's builder."""
    root = tmp_path_factory.mktemp("packed")
    return write_chunks(jpd, root / "j"), write_chunks(tpd, root / "t")


def test_builders_write_the_same_files_and_readers_agree(chunks):
    jfiles, tfiles = chunks
    assert [f.name for f in jfiles] == [f.name for f in tfiles]
    for a, b in zip(jfiles, tfiles):
        assert a.read_bytes() == b.read_bytes()
        assert tpd.read_header(b) == jpd.read_header(a)
    for kw in (dict(n_chunks=2, shuffle=True, seed=7), dict(n_chunks=1, shuffle=False),
               dict(n_chunks=3, shuffle=True, seed=1, num_processes=2, process_rank=1)):
        want = list(jpd.PackedDataset(jfiles, block_size=128, **kw))
        got = list(tpd.PackedDataset(tfiles, block_size=128, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    combined = tpd.CombinedDataset([tpd.PackedDataset(tfiles, 1, 128, seed=2),
                                    tpd.PackedDataset(tfiles[::-1], 1, 128, seed=3)], seed=4)
    jcombined = jpd.CombinedDataset([jpd.PackedDataset(jfiles, 1, 128, seed=2),
                                     jpd.PackedDataset(jfiles[::-1], 1, 128, seed=3)], seed=4)
    for a, b in zip(list(combined)[:20], list(jcombined)[:20]):
        np.testing.assert_array_equal(a, b)


def _blocks(files, **kw):
    return list(tloader.NativePackedDataset(files, 128, **kw))


@pytest.mark.parametrize("mode", ["unshuffled", "shuffled", "wrap", "ranks", "numpy"])
def test_native_reader_matches_the_numpy_reader(chunks, mode):
    """As tests/test_native_loader.py holds the JAX package's; the library is
    built from the port's own source into fastmax_tpu_torch/_build/."""
    files = chunks[1]
    ref = list(tpd.PackedDataset(files, n_chunks=1, block_size=128, shuffle=False, wrap=False))
    if mode == "unshuffled":
        nat = _blocks(files, shuffle=False, wrap=False)
        assert len(nat) == len(ref)
        for a, b in zip(nat, ref):
            np.testing.assert_array_equal(a, b)
        assert tloader.library_path().is_file()
        assert tloader.library_path().parent == Path(tpd.__file__).parents[1] / "_build"
    elif mode == "shuffled":
        nat = _blocks(files, shuffle=True, seed=7, wrap=False)
        assert sorted(a.tobytes() for a in nat) == sorted(a.tobytes() for a in ref)
        assert any(not np.array_equal(a, b) for a, b in zip(nat, ref))
    elif mode == "wrap":
        it = iter(tloader.NativePackedDataset(files, 128, shuffle=False, wrap=True))
        got = [next(it) for _ in range(len(ref) + 5)]
        for a, b in zip(got, ref + ref[:5]):
            np.testing.assert_array_equal(a, b)
    elif mode == "ranks":
        r0 = _blocks(files, shuffle=False, num_processes=2, process_rank=0)
        r1 = _blocks(files, shuffle=False, num_processes=2, process_rank=1)
        assert len(r0) + len(r1) == len(ref)
        assert {a.tobytes() for a in r0} | {a.tobytes() for a in r1} == \
            {a.tobytes() for a in ref}
    else:  # native=False is PackedDataset over the same files, as the reference's fallback
        got = _blocks(files, seed=9, native=False)
        want = list(jpd.PackedDataset(chunks[0], n_chunks=min(8, len(files)), block_size=128,
                                      seed=9))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


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


def test_prepare_packed_writes_the_jax_files(tmp_path):
    tok = tmp_path / "tok"
    write_tokenizer(tok)
    src = tmp_path / "src"
    src.mkdir()
    words = TEXT.split()
    rng = np.random.default_rng(6)
    docs = [" ".join(rng.choice(words, 30)) for _ in range(12)]
    (src / "a.jsonl").write_text("\n".join(json.dumps({"text": t}) for t in docs[:8]) + "\n")
    (src / "b.txt").write_text(" ".join(docs[8:]))
    jprep.prepare(src, tok, tmp_path / "j", chunk_size=99)
    tprep.main(["--source_path", str(src), "--checkpoint_dir", str(tok), "--destination_path",
                str(tmp_path / "t"), "--chunk_size", "99"])
    want = sorted((tmp_path / "j").glob("*.bin"))
    got = sorted((tmp_path / "t").glob("*.bin"))
    assert [f.name for f in got] == [f.name for f in want] and len(got) > 2
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(got, want))


# ------------------------------------------------------------------ loggers


def test_loggers(tmp_path, monkeypatch, capsys):
    """TensorBoard writes an event file; W&B hands the logged dict to the
    package (a fake ``wandb`` module here: the package is not installed);
    with a package absent the choice falls back to CSV, as the reference's."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # tensorboard's stub, not TF's import
    tb = tlogging.choose_logger("tensorboard", tmp_path)
    tb.log_dict({"loss": 1.5, "note": "skipped"}, 3)
    tb.finalize()
    assert [f.stat().st_size > 0 for f in (tmp_path / "tb").glob("events.out.tfevents.*")] == \
        [True]

    runs = []

    class Run:
        def __init__(self, **kw):
            self.kw, self.logged, self.finished = kw, [], False
            runs.append(self)

        def log(self, metrics, step):
            self.logged.append((dict(metrics), step))

        def finish(self):
            self.finished = True

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=lambda **kw: Run(**kw)))
    wb = tlogging.choose_logger("wandb", tmp_path, project="p", name="n")
    wb.log_dict({"loss": 2.0}, 5)
    wb.finalize()
    (run,) = runs
    assert run.kw == {"project": "p", "name": "n"} and run.logged == [({"loss": 2.0}, 5)]
    assert run.finished

    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for kind in ("wandb", "tensorboard"):
        capsys.readouterr()
        lg = tlogging.choose_logger(kind, tmp_path / kind)
        assert isinstance(lg, tlogging.CSVLogger)
        assert f"{kind} not installed; falling back to CSV" in capsys.readouterr().out
    with pytest.raises(ValueError):
        tlogging.choose_logger("mlflow", tmp_path)


# ------------------------------------------------------------------ bench_mfu


@pytest.fixture
def jax_cache_config():
    """bench_mfu's enable_compile_cache changes jax's process-wide settings:
    put them back after the test."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_bench_mfu_runs_and_matches_jax(monkeypatch, jax_cache_config):
    out = bench_mfu.run(model_name="pythia-14m", seq_len=64, micro_batch=1, iters=2,
                        device="cpu")
    assert out["device_kind"] == "cpu" and out["mfu"] is None and out["peak_hbm_gb"] == 0
    assert out["remat"] == "full" and out["step_time_ms"] > 0 and np.isfinite(out["loss"])
    # against the JAX package on the tiny GPT-NeoX: it splits the batch over its 8 CPU
    # devices (fsdp=1: data parallel), so 8 rows; the same bf16 weights on both sides
    # (the JAX package's init); one warm step and one timed step
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg[NEOX["name"]] = dict(NEOX)
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)
    jp = jgpt.init_params(JaxConfig(**{**NEOX, "block_size": 32}), jax.random.PRNGKey(0),
                          jnp.bfloat16)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    monkeypatch.setattr(bench_mfu.gpt, "init_params",
                        lambda cfg, seed, dtype, device: from_numpy_params_bf16(tree))
    kw = dict(model_name=NEOX["name"], seq_len=32, micro_batch=8, iters=1, remat="attn", fsdp=1)
    want = jbench.run(**kw)
    got = bench_mfu.run(**kw, device="cpu")
    assert set(got) == set(want)
    for key in ("model", "remat", "optimizer", "accum", "attn_alg", "micro_batch", "seq_len",
                "n_params", "unroll", "lm_head_chunk"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)
    # fsdp 2 runs on a mesh now (tests/test_torch_train_mesh.py): alone, the torchrun line
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m "
                       "fastmax_tpu_torch.training.bench_mfu"):
        bench_mfu.run(model_name="pythia-14m", fsdp=2, device="cpu")


def from_numpy_params_bf16(tree: dict) -> dict:
    return {k: from_numpy_params_bf16(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in tree.items()}
