"""LLaMA-Adapter v1 and v2 in the port (models/adapter.py, the adapter leaves
of ops/linear.py, the prefix attention of models/gpt._finish_attn, the
``adapter``/``adapter_v2`` methods of training/finetune.py and
inference/generate.apply_finetuned) against the JAX package on the CPU, on
the same weights (the JAX package's leaves brought over by
``from_numpy_params``).

A 2-layer, 128-wide LLaMA (tests/test_torch_finetune.py's), adapter prompt
of 5 tokens from layer 1. Tolerances, float32: identity at init atol 1e-6
(tests/test_peft.py:140-190); logits 1e-4; after two fit steps each trainable
leaf within 1e-4 of the JAX package's (Adam divides each gradient by its own
running magnitude, tests/test_torch_finetune.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from fastmax_tpu.data.lm_datasets import SFTDataset as JaxSFTDataset
from fastmax_tpu.inference import generate as jgenerate
from fastmax_tpu.models import adapter as jadapter
from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.training import finetune as jfinetune
from fastmax_tpu.training import fit as jfit
from fastmax_tpu.utils.args import IOArgs as JaxIOArgs
from fastmax_tpu.utils.args import TrainArgs as JaxTrainArgs
from fastmax_tpu_torch.data.lm_datasets import SFTDataset
from fastmax_tpu_torch.inference import generate
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models import adapter
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.ops import quant
from fastmax_tpu_torch.ops.linear import linear
from fastmax_tpu_torch.training import finetune, fit
from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs
from fastmax_tpu_torch.utils.checkpoint import save_flat_checkpoint

torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(name="tiny-llama", block_size=256, vocab_size=256, padded_vocab_size=256,
            n_layer=2, n_head=2, n_embd=128, n_query_groups=1, intermediate_size=256,
            _norm_class="RMSNorm", _mlp_class="LLaMAMLP", bias=False, rotary_percentage=1.0,
            parallel_residual=False, attn_alg="quadratic")
AD = dict(adapter_prompt_length=5, adapter_start_layer=1)
METHODS = ("adapter", "adapter_v2")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _set(tree, name, value):
    *path, leaf = name.split(".")
    for k in path:
        tree = tree[k]
    tree[leaf] = value


def _jax_tree(v2: bool, quantize=None, seed=0, **ad):
    jcfg = JaxConfig(**TINY)
    base = jgpt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if quantize:
        base = jquant.quantize_model(base, quantize)
    tree = jadapter.add_adapter_params(base, jcfg, jadapter.AdapterConfig(**{**AD, **ad}),
                                       jax.random.PRNGKey(seed + 1), v2=v2)
    return jcfg, jax.tree.map(np.asarray, base), jax.tree.map(np.asarray, tree)


def _tokens(seed=0, shape=(2, 17)):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _logits_both(jcfg, tree, tok):
    want, _ = jgpt.forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(tok, jnp.int32))
    got, _ = gpt.forward(from_numpy_params(tree, "cpu"), Config(**TINY), torch.from_numpy(tok))
    return got.detach().numpy(), np.asarray(want)


# ------------------------------------------------------------------ the leaves


@pytest.mark.parametrize("method", METHODS)
def test_adapter_params_match_jax_and_are_identity_at_init(method):
    """The port's own leaves have the JAX package's names, shapes, dtypes and
    (but for the drawn prompt) values; at init both are the base model to
    atol 1e-6."""
    v2 = method == "adapter_v2"
    jcfg, base, jtree = _jax_tree(v2)
    cfg = Config(**TINY)
    ttree = adapter.add_adapter_params(from_numpy_params(base, "cpu"), cfg,
                                       adapter.AdapterConfig(**AD),
                                       torch.Generator().manual_seed(1), v2=v2)
    want, got = _flat(jtree), _flat(to_numpy_params(ttree))
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].shape == want[n].shape and got[n].dtype == want[n].dtype, n
        if not n.endswith("adapter.wte"):
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    tok = _tokens()
    plain, _ = gpt.forward(from_numpy_params(base, "cpu"), cfg, torch.from_numpy(tok))
    for tree in (ttree, from_numpy_params(jtree, "cpu")):
        out, _ = gpt.forward(tree, cfg, torch.from_numpy(tok))
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("method", METHODS)
def test_prefix_attention_matches_jax(method):
    """With the gates and (v2) the wrappers moved off their init, the
    no-cache and the cached forward give the JAX package's logits."""
    jcfg, _, tree = _jax_tree(method == "adapter_v2")
    rng = np.random.default_rng(2)
    tree["blocks"]["attn"]["adapter"]["gating"] = rng.standard_normal((2, 2)).astype(np.float32)
    for n, a in _flat(tree).items():
        if n.endswith("adapter_scale"):
            _set(tree, n, (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32))
        if n.endswith("adapter_bias"):
            _set(tree, n, (0.02 * rng.standard_normal(a.shape)).astype(np.float32))
    tok = _tokens(1)
    got, want = _logits_both(jcfg, tree, tok)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    cfg, tp = Config(**TINY), from_numpy_params(tree, "cpu")
    base, _ = gpt.forward(from_numpy_params(_jax_tree(False)[1], "cpu"), cfg,
                          torch.from_numpy(tok))
    assert np.abs(got - base.numpy()).max() > 1e-3  # the adapter moved the logits
    cache = gpt.init_kv_cache(cfg, 2, 32, torch.float32, "cpu")
    steps, cache = gpt.forward(tp, cfg, torch.from_numpy(tok[:, :12]), input_pos=0,
                               kv_cache=cache)
    steps = [steps]
    for pos in range(12, 17):
        s, cache = gpt.forward(tp, cfg, torch.from_numpy(tok[:, pos:pos + 1]), input_pos=pos,
                               kv_cache=cache)
        steps.append(s)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), want, atol=1e-4, rtol=0)


def test_start_layer_turns_the_prefix_off():
    """Below adapter_start_layer the prefix adds nothing, even with the gates
    at one (tests/test_peft.py:161)."""
    jcfg, base, tree = _jax_tree(False, adapter_start_layer=2)
    tree["blocks"]["attn"]["adapter"]["gating"] = np.ones((2, 2), np.float32)
    assert not tree["blocks"]["attn"]["adapter"]["on"].any()
    tok = _tokens(2)
    got, want = _logits_both(jcfg, tree, tok)
    plain, _ = gpt.forward(from_numpy_params(base, "cpu"), Config(**TINY), torch.from_numpy(tok))
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("base", ["dense", "bnb.nf4", "bnb.int8"])
def test_v2_wrapper_on_every_linear_format(base):
    """scale * linear(x) + bias after the bias, on a dense, an NF4 and an
    int8 linear, stacked and per layer, against the JAX linear (atol 1e-6)."""
    from fastmax_tpu.ops import linear as jlinear

    rng = np.random.default_rng(3)
    p = {"kernel": (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)}
    if base != "dense":
        p = jax.tree.map(np.asarray, jquant.quantize_linear_params(p, base))
    p.update(bias=(0.1 * rng.standard_normal(96)).astype(np.float32),
             adapter_scale=(1 + 0.3 * rng.standard_normal(96)).astype(np.float32),
             adapter_bias=(0.1 * rng.standard_normal(96)).astype(np.float32))
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = np.asarray(jlinear.linear(p, jnp.asarray(x)))
    got = linear(from_numpy_params(p, "cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    stacked = {k: np.stack([v, v]) if np.ndim(v) else v for k, v in p.items()}
    got1 = linear(from_numpy_params(stacked, "cpu"), torch.from_numpy(x), 1).numpy()
    np.testing.assert_allclose(got1, want, atol=1e-6, rtol=0)


def test_v2_wrappers_skip_the_experts_and_survive_the_weights_modes():
    """The MoE experts get no wrapper (the reference contracts them directly);
    the router does. The port keeps a linear's wrapper through quantize and
    every weights mode (the reference drops it there: ROADMAP.md C)."""
    conf = dict(TINY, name="moe-tiny", _mlp_class="LLaMAMoE", n_expert=4, n_expert_per_token=2)
    jcfg, cfg = JaxConfig(**conf), Config(**conf)
    jp = jadapter.add_adapter_params(jgpt.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                                     jadapter.AdapterConfig(**AD), jax.random.PRNGKey(1), v2=True)
    tp = adapter.add_adapter_params(gpt.init_params(cfg, 0, torch.float32, "cpu"), cfg,
                                    adapter.AdapterConfig(**AD), torch.Generator().manual_seed(1),
                                    v2=True)
    names = sorted(n for n in _flat(to_numpy_params(tp)) if "adapter_" in n)
    assert names == sorted(n for n in _flat(jax.tree.map(np.asarray, jp)) if "adapter_" in n)
    assert "blocks.mlp.gate.adapter_scale" in names
    assert not any("experts" in n for n in names)
    q = quant.quantize_model(tp, "bnb.nf4")
    for mode in ("preload", "preload_int8", "preload_int4", "preload_int4_block"):
        served = InferenceEngine.prepare_params(q, mode)
        for key in ("attn", "proj"):
            assert {"adapter_scale", "adapter_bias"} <= set(served["blocks"]["attn"][key]), mode


@pytest.mark.parametrize("quantize", [None, "bnb.nf4"])
@pytest.mark.parametrize("method", METHODS)
def test_trainable_masks_and_filters_match_jax(method, quantize):
    v2 = method == "adapter_v2"
    _, _, jtree = _jax_tree(v2, quantize)
    tp = from_numpy_params(jtree, "cpu")
    assert _flat(adapter.trainable_mask(tp, v2)) == _flat(jadapter.trainable_mask(jtree, v2))
    for n in list(_flat(jtree)) + ["transformer.h.0.attn.adapter_wte",
                                   "transformer.h.0.attn.gating_factor", "lm_head.bias"]:
        assert adapter.adapter_filter_flat(n, v2) == jadapter.adapter_filter_flat(n, v2), n


# ------------------------------------------------------------------ finetuning


def _sft_examples(n, lo, hi, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(3, vocab, int(rng.integers(lo, hi))).astype(np.int64)
        y = x.copy()
        y[: len(x) // 4] = -1
        out.append({"input_ids": x, "labels": y})
    return out


@pytest.mark.parametrize("method", METHODS)
def test_two_fit_steps_match_jax(method):
    """Two steps (global batch 4, micro-batch 2) of the masked AdamW on an
    NF4 base, gates started off zero so that the prompt also trains, against
    the JAX fit: each trainable leaf within 1e-4, the frozen ones unmoved."""
    v2 = method == "adapter_v2"
    jcfg, _, jtree = _jax_tree(v2, "bnb.nf4", seed=4)
    jtree["blocks"]["attn"]["adapter"]["gating"] = np.full((2, 2), 0.5, np.float32)
    cfg = Config(**TINY)
    examples = _sft_examples(8, 20, 60, seed=5)
    kw = dict(global_batch_size=4, micro_batch_size=2, max_iters=2, learning_rate=1e-3,
              lr_warmup_steps=0, min_lr=1e-3, log_interval=1)
    jtrain, train = JaxTrainArgs(**kw), TrainArgs(**kw)
    jmask = jadapter.trainable_mask(jtree, v2)
    jopt = jfit.build_optimizer(jtrain, jmask)
    jstate = jfit.fit(jcfg, jfit.TrainState(jax.tree.map(jnp.asarray, jtree),
                                            jopt.init(jtree)), jopt,
                      JaxSFTDataset(examples, 0).batches(2), train=jtrain,
                      loss_fn=jfinetune.sft_loss_fn(jcfg))
    tp = from_numpy_params(jtree, "cpu")
    mask = adapter.trainable_mask(tp, v2)
    opt = fit.build_optimizer(train, mask)
    state = fit.fit(cfg, fit.TrainState(tp, opt.init(tp)), opt,
                    SFTDataset(examples, 0).batches(2), train=train,
                    loss_fn=finetune.sft_loss_fn(cfg), trainable=mask)
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_numpy_params(state.params))
    trained = {n for n, m in _flat(mask).items() if m}
    assert any(n.endswith("adapter.wte") for n in trained)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4 if n in trained else 0, rtol=0,
                                   err_msg=n)
        if n.endswith(("gating", "adapter.wte")):
            assert not np.array_equal(got[n], _flat(jtree)[n]), n


@pytest.fixture
def tiny_registry(monkeypatch):
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg["tiny-llama"] = dict(TINY)
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)


@pytest.mark.parametrize("method", METHODS)
def test_setup_writes_the_jax_delta(tmp_path, tiny_registry, method):
    """finetune.setup with the adapter methods on an NF4 base, in both
    packages: the delta file holds the same names, shapes and dtypes, and the
    run's own leaves."""
    data = tmp_path / "sft.npz"
    np.savez(data, examples=np.array(_sft_examples(8, 30, 80), dtype=object))
    kw = dict(global_batch_size=2, micro_batch_size=2, max_iters=2, learning_rate=1e-3,
              log_interval=1, max_seq_length=64)
    common = dict(method=method, model_name="tiny-llama", data_path=data, quantize="bnb.nf4",
                  precision="float32", adapter_prompt_length=4, adapter_start_layer=1)
    jfinetune.setup(**common, train=JaxTrainArgs(**kw), io=JaxIOArgs(out_dir=tmp_path / "j"))
    state = finetune.setup(**common, train=TrainArgs(**kw), io=IOArgs(out_dir=tmp_path / "t"),
                           device="cpu")
    assert state.step == 2
    want = load_file(str(tmp_path / "j" / f"{method}_weights.safetensors"))
    got = load_file(str(tmp_path / "t" / f"{method}_weights.safetensors"))
    assert sorted(got) == sorted(want)
    assert "blocks.attn.adapter.gating" in got and "blocks.attn.adapter.on" not in got
    assert any("adapter_scale" in n for n in got) == (method == "adapter_v2")
    own = _flat(to_numpy_params(state.params))
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        np.testing.assert_array_equal(got[n], own[n], err_msg=n)


@pytest.mark.parametrize("method", METHODS)
def test_apply_finetuned_reads_the_delta_back(tmp_path, method):
    """apply_finetuned sets the delta's leaves on the base; its forward gives
    the trained tree's logits, and the JAX apply_finetuned's on the same
    file (given ``on``, which the reference's file leaves out: ROADMAP.md C)."""
    v2 = method == "adapter_v2"
    jcfg, base, tree = _jax_tree(v2, seed=6)
    rng = np.random.default_rng(7)
    tree["blocks"]["attn"]["adapter"]["gating"] = np.array([[0.0, 0.0], [0.7, -0.4]],
                                                           np.float32)
    delta = {}
    for n, a in _flat(tree).items():
        if jadapter.adapter_filter_flat(n, v2):
            a = a + (0.05 * rng.standard_normal(a.shape)).astype(np.float32) \
                if not n.endswith("gating") else a
            _set(tree, n, a.astype(np.float32))
            delta[n] = a.astype(np.float32)
    path = tmp_path / f"{method}_weights.safetensors"
    save_flat_checkpoint(delta, path)
    cfg = Config(**TINY)
    loaded = generate.apply_finetuned(from_numpy_params(base, "cpu"), cfg, path, method,
                                      torch.float32)
    assert "on" not in loaded["blocks"]["attn"]["adapter"]
    tok = _tokens(3)
    got, _ = gpt.forward(loaded, cfg, torch.from_numpy(tok))
    want, _ = gpt.forward(from_numpy_params(tree, "cpu"), cfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    jtree = jgenerate.apply_finetuned(jax.tree.map(jnp.asarray, base), jcfg, path, method,
                                      jnp.float32)
    jtree["blocks"]["attn"]["adapter"]["on"] = jnp.asarray(tree["blocks"]["attn"]["adapter"]["on"])
    jl, _ = jgpt.forward(jtree, jcfg, jnp.asarray(tok, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    eng = InferenceEngine(cfg, loaded, max_seq_length=32, device="cpu")
    out = eng.generate(torch.from_numpy(tok[0, :8]), 16)
    ref = np.asarray(tok[0, :8]).tolist()
    for _ in range(8):  # greedy by the no-cache forward
        logits, _ = gpt.forward(loaded, cfg, torch.tensor([ref]))
        ref.append(int(logits[0, -1].argmax()))
    assert out[0].tolist() == ref
