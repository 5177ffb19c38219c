"""The port's checkpoint plane against the JAX package on the CPU:
models/params.py (the tree <-> lit-gpt flat names), utils/checkpoint.py (the
npy directory, lit_model.pth and model.safetensors, read and written across
the two packages) and scripts/convert_hf_checkpoint.py (the HF converter, on
tiny HF models built from config with transformers, never downloaded).

Trees are drawn with numpy from a seed in the JAX package's shapes. The
layouts and formats hold bit for bit in float32; converted models reproduce
HF's logits at the JAX package's own tolerance there (atol 3e-4, rtol 1e-3,
tests/test_against_hf.py).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import params as jparams
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.scripts import convert_hf_checkpoint as jconv
from fastmax_tpu.utils import checkpoint as jckpt
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.params import flat_to_params, params_to_flat
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.scripts import convert_hf_checkpoint as tconv
from fastmax_tpu_torch.utils.checkpoint import (check_valid_checkpoint_dir, load_flat_checkpoint,
                                                load_model_params, save_flat_checkpoint)

LLAMA_GQA = dict(name="ck-llama", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2,
                 n_head=4, n_embd=64, n_query_groups=2, intermediate_size=112,
                 rotary_percentage=1.0, parallel_residual=False, bias=False,
                 _norm_class="RMSNorm", _mlp_class="LLaMAMLP")
NEOX_BIAS = dict(name="ck-neox", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2,
                 n_head=4, n_embd=64, intermediate_size=256, rotary_percentage=0.25,
                 parallel_residual=True, bias=True, lm_head_bias=True)
LLAMA_MOE = dict(name="ck-moe", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2,
                 n_head=4, n_embd=32, n_query_groups=2, intermediate_size=48,
                 rotary_percentage=1.0, parallel_residual=False, bias=False,
                 _norm_class="RMSNorm", _mlp_class="LLaMAMoE", n_expert=4, n_expert_per_token=2)
CONFIGS = {"llama_gqa": LLAMA_GQA, "neox_bias": NEOX_BIAS, "llama_moe": LLAMA_MOE}


def numpy_tree(conf: dict, seed: int = 0) -> dict:
    """A parameter tree in the JAX package's shapes, float32 values from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jgpt.init_params(JaxConfig(**conf), jax.random.PRNGKey(0)))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.05, shapes)


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture
def registries(monkeypatch):
    """A function that adds an entry to both packages' registries."""
    regs = {}
    for mod in (jconfig_mod, tconfig_mod):
        regs[mod] = dict(mod.registry())
        monkeypatch.setattr(mod, "registry", lambda reg=regs[mod]: reg)

    def add(conf: dict) -> str:
        for reg in regs.values():
            reg[conf["name"]] = dict(conf)
        return conf["name"]

    return add


# ------------------------------------------------------------------ layout


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_params_to_flat_matches_jax(which):
    conf = CONFIGS[which]
    tree = numpy_tree(conf)
    want = jparams.params_to_flat(tree, JaxConfig(**conf))
    got = params_to_flat(from_numpy_params(tree, "cpu"), Config(**conf))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if which == "neox_bias":
        assert {"lm_head.bias", "transformer.ln_f.bias", "transformer.h.1.mlp.fc.bias"} <= set(got)
    if which == "llama_moe":
        assert "transformer.h.1.mlp.experts.3.proj.weight" in got


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_flat_to_params_matches_jax(which):
    conf = CONFIGS[which]
    flat = jparams.params_to_flat(numpy_tree(conf, 1), JaxConfig(**conf))
    want = jax.tree.map(np.asarray, jparams.flat_to_params(flat, JaxConfig(**conf), jnp.float32))
    got = flat_to_params(flat, Config(**conf), torch.float32, "cpu")
    assert_trees_equal(got, want)
    # from torch tensors (the port's own flats), and in bfloat16 as JAX rounds
    back = flat_to_params({k: torch.from_numpy(v) for k, v in flat.items()}, Config(**conf),
                          torch.float32, "cpu")
    assert_trees_equal(back, want)
    want16 = jparams.flat_to_params(flat, JaxConfig(**conf), jnp.bfloat16)
    got16 = flat_to_params(flat, Config(**conf), torch.bfloat16, "cpu")
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want16)[0],
                            jax.tree.leaves(to_numpy_params(got16))):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=str(path))
    assert got16["wte"].dtype == torch.bfloat16


def test_flat_to_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    flat = jparams.params_to_flat(numpy_tree(LLAMA_GQA), JaxConfig(**LLAMA_GQA))
    with pytest.raises(RuntimeError, match="CUDA"):
        flat_to_params(flat, Config(**LLAMA_GQA))


# ------------------------------------------------------------------ formats

LAYOUTS = {"npy": "", "pth": "lit_model.pth", "safetensors": "model.safetensors"}


def write_dir(save, flat, conf, root: Path, layout: str) -> Path:
    d = root / layout
    d.mkdir(parents=True)
    save(flat, d / LAYOUTS[layout] if LAYOUTS[layout] else d)
    JaxConfig(**conf).to_json(d / "lit_config.json")
    return d


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_jax_checkpoints_load_in_the_port(tmp_path, layout):
    conf = LLAMA_GQA
    tree = numpy_tree(conf, 2)
    flat = jparams.params_to_flat(tree, JaxConfig(**conf))
    d = write_dir(jckpt.save_flat_checkpoint, flat, conf, tmp_path, layout)
    cfg, params = load_model_params(d, device="cpu")
    assert cfg == Config(**conf)
    assert_trees_equal(params, tree)
    back = load_flat_checkpoint(d)
    assert sorted(back) == sorted(flat)
    for name, w in flat.items():
        np.testing.assert_array_equal(back[name].numpy(), w, err_msg=name)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_checkpoints_load_in_jax(tmp_path, layout):
    conf = NEOX_BIAS
    tree = numpy_tree(conf, 3)
    flat = params_to_flat(from_numpy_params(tree, "cpu"), Config(**conf))
    d = write_dir(save_flat_checkpoint, flat, conf, tmp_path, layout)
    jcfg, jtree = jckpt.load_model_params(d)
    assert jcfg == JaxConfig(**conf)
    assert_trees_equal(jax.tree.map(np.asarray, jtree), tree)
    if layout == "npy":  # the same files, byte for byte, as the JAX package writes
        jd = write_dir(jckpt.save_flat_checkpoint, jparams.params_to_flat(tree, JaxConfig(**conf)),
                       conf, tmp_path / "jax", layout)
        names = json.loads((d / "model" / "index.json").read_text())
        assert (d / "model" / "index.json").read_text() == \
            (jd / "model" / "index.json").read_text()
        for n in names:
            assert (d / "model" / f"{n}.npy").read_bytes() == \
                (jd / "model" / f"{n}.npy").read_bytes(), n


def test_bfloat16_npy_directory_from_jax(tmp_path):
    """The JAX package writes bfloat16 leaves as 2-byte void .npy files; the
    port reads them as the same bf16 values and writes the same bytes. The
    JAX package's own loader cannot read such a file (ROADMAP §C)."""
    conf = LLAMA_GQA
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), numpy_tree(conf, 4))
    flat = jparams.params_to_flat(tree, JaxConfig(**conf))
    d = write_dir(jckpt.save_flat_checkpoint, flat, conf, tmp_path, "npy")
    back = load_flat_checkpoint(d)
    for name, w in flat.items():
        assert back[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(back[name].view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16), err_msg=name)
    _, params = load_model_params(d, dtype=torch.bfloat16, device="cpu")
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(params)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16), err_msg=str(path))
    ours = tmp_path / "port"
    save_flat_checkpoint(back, ours)
    for name in flat:
        f = f"model/{name}.npy"
        assert (ours / f).read_bytes() == (d / f).read_bytes(), name
    with pytest.raises(ValueError, match="sequence"):
        jckpt.load_model_params(d)


def test_safetensors_reader_checks_bounds(tmp_path):
    """A tensor read from the mapped data section equals the written one; a
    header that points past the data is refused."""
    path = tmp_path / "w.safetensors"
    big = torch.arange(1 << 20, dtype=torch.float32)
    save_flat_checkpoint({"a": torch.ones(3, dtype=torch.uint8), "big": big}, path)
    back = load_flat_checkpoint(path)
    assert torch.equal(back["big"], big) and torch.equal(back["a"], torch.ones(3, dtype=torch.uint8))
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    header["big"]["data_offsets"][1] += 4
    blob = json.dumps(header).encode()
    blob += b" " * ((-len(blob)) % 8)
    (tmp_path / "bad.safetensors").write_bytes(len(blob).to_bytes(8, "little") + blob + raw[8 + n:])
    with pytest.raises(ValueError, match="outside"):
        load_flat_checkpoint(tmp_path / "bad.safetensors")


def test_check_valid_checkpoint_dir(tmp_path):
    with pytest.raises(OSError, match="missing"):
        check_valid_checkpoint_dir(tmp_path)
    save_flat_checkpoint({"a": torch.zeros(2)}, tmp_path)
    for f in ("lit_config.json", "tokenizer.json", "tokenizer_config.json"):
        (tmp_path / f).write_text("{}")
    check_valid_checkpoint_dir(tmp_path)


# ------------------------------------------------------------------ HF converter


def test_weight_maps_and_qkv_layout_match_jax():
    assert tconv.neox_weight_map() == jconv.neox_weight_map()
    assert tconv.phi_weight_map() == jconv.phi_weight_map()
    for name in ("falcon-7b", "falcon-40b", "falcon-180B"):
        assert tconv.falcon_weight_map(name) == jconv.falcon_weight_map(name)
    with pytest.raises(NotImplementedError):
        tconv.falcon_weight_map("falcon-1b")
    for conf in (LLAMA_GQA, LLAMA_MOE):
        assert tconv.llama_weight_map(Config(**conf)) == jconv.llama_weight_map(JaxConfig(**conf))
    rng = np.random.default_rng(5)
    for conf in (LLAMA_GQA, {**LLAMA_GQA, "n_query_groups": 1}, {**LLAMA_GQA,
                                                                  "n_query_groups": 4}):
        jcfg, cfg = JaxConfig(**conf), Config(**conf)
        hs, g = cfg.head_size, cfg.n_query_groups
        q = rng.standard_normal((cfg.n_head * hs, 8)).astype(np.float32)
        k, v = (rng.standard_normal((g * hs, 8)).astype(np.float32) for _ in range(2))
        want = jconv.interleave_qkv(q, k, v, jcfg)
        got = tconv.interleave_qkv(*(torch.from_numpy(x) for x in (q, k, v)), cfg)
        np.testing.assert_array_equal(got.numpy(), want)
        for a, b in zip(tconv.split_qkv(got, cfg), jconv.split_qkv(want, jcfg)):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(tconv.interleave_qkv(*tconv.split_qkv(got, cfg), cfg), got)


HF_MODELS = {
    "llama_gqa": dict(conf=dict(LLAMA_GQA, name="hf-llama-gqa"), tied=False),
    "llama_tied": dict(conf=dict(LLAMA_GQA, name="hf-llama-tied", n_query_groups=4),
                       tied=True),
    "neox": dict(conf=dict(NEOX_BIAS, name="hf-neox", lm_head_bias=False), tied=False),
}


def hf_model(which: str):
    import transformers

    spec = HF_MODELS[which]
    c = spec["conf"]
    common = dict(vocab_size=c["vocab_size"], hidden_size=c["n_embd"],
                  num_attention_heads=c["n_head"], num_hidden_layers=c["n_layer"],
                  intermediate_size=c["intermediate_size"], max_position_embeddings=64,
                  attn_implementation="eager", tie_word_embeddings=spec["tied"])
    torch.manual_seed(3)
    if which == "neox":
        cfg = transformers.GPTNeoXConfig(rotary_pct=c["rotary_percentage"],
                                         use_parallel_residual=True, **common)
        return transformers.GPTNeoXForCausalLM(cfg).eval()
    cfg = transformers.LlamaConfig(num_key_value_heads=c.get("n_query_groups", c["n_head"]),
                                   rms_norm_eps=1e-5, **common)
    model = transformers.LlamaForCausalLM(cfg).eval()
    with torch.no_grad():  # RMSNorm weights off 1, so a swapped norm shows
        for n, p in model.named_parameters():
            if "norm" in n:
                p.uniform_(0.5, 1.5)
    return model


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("which", sorted(HF_MODELS))
def test_converter_matches_jax_and_hf(tmp_path, registries, which, fmt):
    """Both converters give the same names and values from save_pretrained's
    safetensors and .bin; the port's directory reproduces HF's logits."""
    name = registries(HF_MODELS[which]["conf"])
    model = hf_model(which)
    src = tmp_path / "hf"
    model.save_pretrained(src, safe_serialization=fmt == "safetensors")
    assert any(src.glob(f"*.{fmt}"))
    jconv.convert_hf_checkpoint(src, model_name=name, out_dir=tmp_path / "jax")
    out = tconv.main(["--checkpoint_dir", str(src), "--model_name", name,
                      "--out_dir", str(tmp_path / "port")])
    assert out == tmp_path / "port"
    want = dict(jckpt.iter_flat_checkpoint(tmp_path / "jax"))
    got = load_flat_checkpoint(out)
    assert sorted(got) == sorted(want)
    assert ("lm_head.weight" in got) and len(got) == len(jparams.params_to_flat(
        numpy_tree(HF_MODELS[which]["conf"]), JaxConfig(**HF_MODELS[which]["conf"])))
    for n, w in want.items():
        assert got[n].dtype == torch.float32, n
        np.testing.assert_array_equal(got[n].numpy(), w, err_msg=n)
    assert json.loads((out / "lit_config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "lit_config.json").read_text())

    cfg, params = load_model_params(out, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 90, size=(2, 17))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
        ours, _ = gpt.forward(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-4, rtol=1e-3)


def test_converter_dtype_writes_the_jax_bytes(tmp_path, registries):
    """``--dtype bfloat16`` rounds as the JAX converter does: the same files."""
    name = registries(HF_MODELS["llama_gqa"]["conf"])
    src = tmp_path / "hf"
    hf_model("llama_gqa").save_pretrained(src)
    jconv.convert_hf_checkpoint(src, model_name=name, out_dir=tmp_path / "jax", dtype="bfloat16")
    tconv.convert_hf_checkpoint(src, model_name=name, out_dir=tmp_path / "port",
                                dtype="bfloat16")
    names = json.loads((tmp_path / "jax" / "model" / "index.json").read_text())
    assert (tmp_path / "port" / "model" / "index.json").read_text() == \
        (tmp_path / "jax" / "model" / "index.json").read_text()
    for n in names:
        assert (tmp_path / "port" / "model" / f"{n}.npy").read_bytes() == \
            (tmp_path / "jax" / "model" / f"{n}.npy").read_bytes(), n
    with pytest.raises(ValueError, match="safetensors or .bin"):
        tconv.convert_hf_checkpoint(tmp_path / "jax" / "model", model_name=name,
                                    out_dir=tmp_path / "none")
