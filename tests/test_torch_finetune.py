"""The port's QLoRA finetuning path (ops/quant.py NF4, ops/linear.py LoRA,
models/lora.py, gpt.forward_hidden, utils/loss.chunked_cross_entropy,
data/lm_datasets.SFTDataset, the masked optimizer, training/finetune.py,
utils/checkpoint.py) against the JAX package on the CPU, on the same weights
(the JAX package's, brought over by from_numpy_params) and the same numpy
batches.

A 2-layer, 128-wide LLaMA (2 heads of 64 sharing one KV group, vocab 256,
RMSNorm, SwiGLU), so that T = 1024 takes the trainable route: flash2 in
both packages (the JAX side in interpret mode). Tolerances, float32: NF4
codes and scales bit for bit, dequantized weights equal; a LoRA linear atol
1e-6; the loss 1e-5 relative and each LoRA gradient 1e-3 of its largest
entry (the repo's model tolerances, test_torch_training.py); after three fit
steps each LoRA leaf within 1e-4 of the JAX package's (Adam divides each
gradient by its own running magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from fastmax_tpu.data.lm_datasets import SFTDataset as JaxSFTDataset
from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models import lora as jlora
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import attention as jattn
from fastmax_tpu.ops import flash_attention as jfa
from fastmax_tpu.ops import linear as jlinear
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.training import finetune as jfinetune
from fastmax_tpu.training import fit as jfit
from fastmax_tpu.utils.args import IOArgs as JaxIOArgs
from fastmax_tpu.utils.args import TrainArgs as JaxTrainArgs
from fastmax_tpu_torch.data.lm_datasets import SFTDataset
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models import lora
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.ops import attention as tattn
from fastmax_tpu_torch.ops import quant
from fastmax_tpu_torch.ops.linear import linear
from fastmax_tpu_torch.training import finetune, fit
from fastmax_tpu_torch.training.step import tree_leaves
from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs
from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint, save_flat_checkpoint

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(name="tiny-llama", block_size=1024, vocab_size=256, padded_vocab_size=256,
            n_layer=2, n_head=2, n_embd=128, n_query_groups=1, intermediate_size=256,
            _norm_class="RMSNorm", _mlp_class="LLaMAMLP", bias=False, rotary_percentage=1.0,
            parallel_residual=False, attn_alg="quadratic")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture
def flash2_both(monkeypatch):
    """Both packages on the fused flash route; the JAX one in interpret mode."""
    fused = jfa.flash_attention_fused
    monkeypatch.setenv("FASTMAX_TPU_TRAIN_ATTN", "flash2")
    monkeypatch.setattr(jattn, "TRAIN_ATTN", "flash2")
    monkeypatch.setattr(tattn, "TRAIN_ATTN", "flash2")
    monkeypatch.setattr(jfa, "flash_attention_fused",
                        lambda q, k, v, scale=None, interpret=False: fused(q, k, v, scale, True))


# ------------------------------------------------------------------ NF4


@pytest.mark.parametrize("mode", ["bnb.nf4", "bnb.nf4-dq"])
def test_nf4_codes_match_jax_bit_for_bit(mode):
    """A stacked (3, 256, 192) kernel with an all-zero block (absmax 0) and
    values on the codebook's midpoints (the tie rule)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 256, 192)) * 0.02).astype(np.float32)
    w[1, :64, :5] = 0.0
    mids = (jquant.NF4_CODE[1:] + jquant.NF4_CODE[:-1]) / 2
    w[2, :64, 7] = np.resize(mids, 64)
    w[2, 0, 7] = 1.0  # the block's absmax: the others scale to the midpoints exactly
    want = jax.tree.map(np.asarray, jquant._quantize_maybe_stacked({"kernel": w}, mode))
    got = quant._quantize_maybe_stacked({"kernel": torch.from_numpy(w)}, mode)
    assert sorted(got) == sorted(want)
    back = to_numpy_params(from_numpy_params(want, "cpu"))  # the weights bridge keeps the bits
    for k in want:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype == back[k].dtype and g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    for i in range(3):
        jp = {k: v[i] for k, v in want.items()}
        tp = {k: v[i] for k, v in got.items()}
        np.testing.assert_array_equal(quant.dequantize(tp).numpy(),
                                      np.asarray(jquant.dequantize(jp)))
        assert quant.dequantize(tp, torch.bfloat16).dtype == torch.bfloat16


def test_quantize_model_keeps_embeddings_dense_and_refuses_other_modes():
    cfg = Config(**TINY)
    from fastmax_tpu_torch.models import gpt

    params = gpt.init_params(cfg, 0, torch.float32, "cpu")
    q = quant.quantize_model(params, "bnb.nf4")
    assert "kernel" in q["lm_head"] and q["wte"] is params["wte"]
    assert q["blocks"]["attn"]["attn"]["q4"].shape == (2, 64, cfg.qkv_shape)
    # the other modes are ported (tests/test_torch_quant_serving.py); unknown ones raise
    for mode, key in (("bnb.fp4", "q4"), ("bnb.int8", "q8"), ("gptq.int4", "q4")):
        assert key in quant.quantize_model(params, mode)["blocks"]["mlp"]["proj"]
    with pytest.raises(ValueError):
        quant.quantize_model(params, "nf5")


# ------------------------------------------------------------------ LoRA pieces


def test_masks_match_jax():
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    for kw in ({}, {"key": True, "query": False}, {"value": False}):
        np.testing.assert_array_equal(lora.qkv_enable_mask(cfg, lora.LoRAConfig(**kw)),
                                      jlora.qkv_enable_mask(jcfg, jlora.LoRAConfig(**kw)))
    lc = dict(projection=True, mlp=True, head=True)
    jp = jlora.add_lora_params(jgpt.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                               jlora.LoRAConfig(**lc), jax.random.PRNGKey(1))
    tp = lora.add_lora_params(from_numpy_params(jax.tree.map(np.asarray, jgpt.init_params(
        jcfg, jax.random.PRNGKey(0))), "cpu"), cfg, lora.LoRAConfig(**lc),
        torch.Generator().manual_seed(1))
    assert _flat(lora.trainable_mask(tp)) == _flat(jlora.trainable_mask(jp))
    jflat = _flat(jax.tree.map(np.asarray, jp))
    tflat = _flat(to_numpy_params(tp))
    assert sorted(jflat) == sorted(tflat)
    for name, a in jflat.items():
        assert a.shape == tflat[name].shape, name
        if name.endswith(("lora_B", "lora_scale", "lora_mask")):
            np.testing.assert_array_equal(tflat[name], a, err_msg=name)
    base, delta = lora.split_lora_state(tp)
    assert all("lora_" in n for n in _flat(delta)) and not any("lora_" in n for n in _flat(base))
    assert all(lora.lora_filter_flat(n) for n in _flat(delta))


@pytest.mark.parametrize("base", ["dense", "bnb.nf4"])
def test_lora_linear_matches_jax(base):
    rng = np.random.default_rng(3)
    p = {"kernel": rng.standard_normal((128, 96)).astype(np.float32) * 0.05}
    if base != "dense":
        p = jax.tree.map(np.asarray, jquant.quantize_linear_params(p, base))
    p.update({"lora_A": rng.standard_normal((128, 8)).astype(np.float32) * 0.1,
              "lora_B": rng.standard_normal((8, 96)).astype(np.float32) * 0.1,
              "lora_scale": np.float32(2.0),
              "lora_mask": (rng.random(96) > 0.5).astype(np.float32)})
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = np.asarray(jlinear.linear(p, jnp.asarray(x)))
    got = linear(from_numpy_params(p, "cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_merge_lora_folds_the_delta():
    rng = np.random.default_rng(4)
    p = {"kernel": rng.standard_normal((2, 32, 48)).astype(np.float32),
         "lora_A": rng.standard_normal((2, 32, 4)).astype(np.float32),
         "lora_B": rng.standard_normal((2, 4, 48)).astype(np.float32),
         "lora_scale": np.full((2,), 0.5, np.float32),
         "lora_mask": np.ones((2, 48), np.float32)}
    want = jax.tree.map(np.asarray, jlora.merge_lora({"blocks": {"attn": p}}))
    got = lora.merge_lora({"blocks": {"attn": from_numpy_params(p, "cpu")}})
    np.testing.assert_allclose(got["blocks"]["attn"]["kernel"].numpy(),
                               want["blocks"]["attn"]["kernel"], rtol=1e-6, atol=1e-6)
    # a quantized base: dequantized, merged and requantized in its own mode, as the reference
    q = jax.tree.map(np.asarray, jquant.quantize_linear_params({"kernel": p["kernel"][0]},
                                                                "bnb.int8"))
    q.update({k: v[0] for k, v in p.items() if k.startswith("lora_")})
    want = jax.tree.map(np.asarray, jlora.merge_lora({"blocks": {"attn": q}}))["blocks"]["attn"]
    got = lora.merge_lora({"blocks": {"attn": from_numpy_params(q, "cpu")}})["blocks"]["attn"]
    assert sorted(got) == sorted(want) == ["q8", "scale8"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# ------------------------------------------------------------------ model level


def _lora_params(base: str, seed: int = 0, **overrides):
    """JAX params (numpy), LoRA on q and v with lora_B drawn so that the
    deltas reach the loss and lora_A gets a gradient."""
    jcfg = JaxConfig(**{**TINY, **overrides})
    params = jgpt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if base != "dense":
        params = jquant.quantize_model(params, base)
    params = jlora.add_lora_params(params, jcfg, jlora.LoRAConfig(), jax.random.PRNGKey(seed + 1))
    params = jax.tree.map(np.asarray, params)
    qkv = params["blocks"]["attn"]["attn"]
    qkv["lora_B"] = (np.random.default_rng(seed).standard_normal(qkv["lora_B"].shape)
                     * 0.05).astype(np.float32)
    return jcfg, params


def _sft_batch(seed, b=2, t=1024, vocab=256):
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, vocab, (b, t)).astype(np.int64)
    labels = inputs.copy()
    labels[:, : t // 4] = -1
    labels[1, t - 100:] = -1
    return inputs, labels


@pytest.mark.parametrize("base", ["dense", "bnb.nf4"])
def test_sft_loss_and_lora_gradients_match_jax(base, flash2_both):
    jcfg, jp = _lora_params(base)
    cfg = Config(**TINY)
    batch = _sft_batch(1)
    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    jloss, jgrads = jfit.value_and_grad_floats(jfinetune.sft_loss_fn(jcfg), jp, jb)
    tp = from_numpy_params(jp, "cpu")
    mask = tree_leaves(lora.trainable_mask(tp))
    for p, m in zip(tree_leaves(tp), mask):
        p.requires_grad_(m)
    loss = finetune.sft_loss_fn(cfg)(tp, tuple(torch.from_numpy(x) for x in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    names = [n for n in _flat(jp) if n.endswith(("lora_A", "lora_B"))]
    assert len(names) == 2
    tflat = {n: p.grad.numpy() for n, p in zip(_flat(jp), tree_leaves(tp)) if p.grad is not None}
    assert sorted(tflat) == sorted(names)
    for n in names:
        scale = float(np.abs(jflat[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(tflat[n], jflat[n], atol=1e-3 * scale, err_msg=n)


@pytest.mark.parametrize("attn_alg,n_embd", [("fastmax", 256), ("linearmax", 128),
                                             ("performer", 128)])
def test_sft_loss_and_lora_gradients_match_jax_linear_arms(attn_alg, n_embd):
    """The QLoRA loss and LoRA gradients with the fork's linear arms on a
    bnb.nf4 base, against the JAX finetune: fastmax at head size 128 (the
    reversible scan, as Llama-2-7B takes it), linearmax and performer at 64;
    T = 256."""
    overrides = dict(attn_alg=attn_alg, n_embd=n_embd)
    jcfg, jp = _lora_params("bnb.nf4", **overrides)
    cfg = Config(**{**TINY, **overrides})
    assert cfg.head_size == n_embd // 2
    batch = _sft_batch(2, t=256)
    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    jloss, jgrads = jfit.value_and_grad_floats(jfinetune.sft_loss_fn(jcfg), jp, jb)
    tp = from_numpy_params(jp, "cpu")
    for p, m in zip(tree_leaves(tp), tree_leaves(lora.trainable_mask(tp))):
        p.requires_grad_(m)
    loss = finetune.sft_loss_fn(cfg)(tp, tuple(torch.from_numpy(x) for x in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    tflat = {n: p.grad.numpy() for n, p in zip(_flat(jp), tree_leaves(tp)) if p.grad is not None}
    assert sorted(tflat) == sorted(n for n in _flat(jp) if n.endswith(("lora_A", "lora_B")))
    for n, got in tflat.items():
        scale = float(np.abs(jflat[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(got, jflat[n], atol=1e-3 * scale, err_msg=n)


def test_chunked_cross_entropy_matches_jax():
    from fastmax_tpu.utils import loss as jloss_mod
    from fastmax_tpu_torch.utils.loss import chunked_cross_entropy

    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 300, 32)).astype(np.float32)
    head = {"kernel": rng.standard_normal((32, 50)).astype(np.float32)}
    tgt = rng.integers(0, 50, (2, 300))
    tgt[0, :30] = -1
    for chunk in (128, 0, 500):
        want = float(jloss_mod.chunked_cross_entropy(jnp.asarray(h), head, jnp.asarray(tgt),
                                                     chunk))
        got = float(chunked_cross_entropy(torch.from_numpy(h), from_numpy_params(head, "cpu"),
                                          torch.from_numpy(tgt), chunk))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _sft_examples(n, lo, hi, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(3, vocab, int(rng.integers(lo, hi))).astype(np.int64)
        y = x.copy()
        y[: len(x) // 4] = -1
        out.append({"input_ids": x, "labels": y})
    return out


def test_sft_dataset_matches_jax(tmp_path):
    path = tmp_path / "sft.npz"
    np.savez(path, examples=np.array(_sft_examples(9, 20, 150), dtype=object))
    pt = tmp_path / "sft.pt"
    torch.save([{"input_ids": torch.from_numpy(e["input_ids"]),
                 "labels": torch.from_numpy(e["labels"])} for e in _sft_examples(5, 20, 90)], pt)
    for p in (path, pt):
        ours, ref = SFTDataset.load(p, 3), JaxSFTDataset.load(p, 3)
        for max_len in (None, 100):
            for a, b in zip(ours.sample_batch(3, max_len), ref.sample_batch(3, max_len)):
                np.testing.assert_array_equal(a, b)


def test_three_fit_steps_match_jax():
    """Three steps (global batch 4, micro-batch 2) of the masked AdamW (clip
    over the LoRA leaves alone) against the JAX fit with its
    masked_optimizer, on an NF4 base and the same SFT batches (T 64 and
    128). lr 1e-3 without warmup, so every step moves the leaves."""
    jcfg, jp = _lora_params("bnb.nf4", seed=2)
    cfg = Config(**TINY)
    examples = _sft_examples(16, 30, 120, seed=4)
    kw = dict(global_batch_size=4, micro_batch_size=2, max_iters=3, learning_rate=1e-3,
              lr_warmup_steps=0, min_lr=1e-3, log_interval=1, max_norm=0.05)
    jtrain, train = JaxTrainArgs(**kw), TrainArgs(**kw)
    jtrainable = jlora.trainable_mask(jp)
    jopt = jfit.build_optimizer(jtrain, jtrainable)
    jstate = jfit.fit(jcfg, jfit.TrainState(jax.tree.map(jnp.asarray, jp), jopt.init(jp)), jopt,
                      JaxSFTDataset(examples, 0).batches(2), train=jtrain,
                      loss_fn=jfinetune.sft_loss_fn(jcfg))
    tp = from_numpy_params(jp, "cpu")
    trainable = lora.trainable_mask(tp)
    opt = fit.build_optimizer(train, trainable)
    state = fit.fit(cfg, fit.TrainState(tp, opt.init(tp)), opt,
                    SFTDataset(examples, 0).batches(2), train=train,
                    loss_fn=finetune.sft_loss_fn(cfg), trainable=trainable)
    assert state.step == 3 and len(state.opt_state["mu"]) == 2
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_numpy_params(state.params))
    for n in want:
        if "lora_" in n or n.endswith(("q4", "absmax")):
            np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0, err_msg=n)
    lora_b = jp["blocks"]["attn"]["attn"]["lora_B"]
    assert not np.array_equal(got["blocks.attn.attn.lora_B"], lora_b)


@pytest.fixture
def tiny_registry(monkeypatch):
    """The tiny LLaMA as a registry entry of both packages."""
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg["tiny-llama"] = dict(TINY)
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)


def test_setup_end_to_end_and_checkpoint_like_jax(tmp_path, tiny_registry):
    """finetune.setup on the CPU (QLoRA on an NF4 base, 2 steps over a tiny
    .npz); its lora_weights.safetensors read back by the safetensors package
    holds the tensors the JAX setup writes, by name, shape and dtype, with
    equal lora_scale and lora_mask (lora_A/lora_B differ: another generator
    draws them), and equals the run's own LoRA leaves."""
    data = tmp_path / "sft.npz"
    np.savez(data, examples=np.array(_sft_examples(12, 40, 120), dtype=object))
    kw = dict(global_batch_size=4, micro_batch_size=2, max_iters=2, learning_rate=1e-3,
              log_interval=1, max_seq_length=128)
    common = dict(method="lora", model_name="tiny-llama", data_path=data, quantize="bnb.nf4",
                  precision="float32", lora_key=True)
    jfinetune.setup(**common, train=JaxTrainArgs(**kw), io=JaxIOArgs(out_dir=tmp_path / "j"))
    state = finetune.setup(**common, train=TrainArgs(**kw), io=IOArgs(out_dir=tmp_path / "t"),
                           device="cpu")
    assert state.step == 2
    want = load_file(str(tmp_path / "j" / "lora_weights.safetensors"))
    got = load_file(str(tmp_path / "t" / "lora_weights.safetensors"))
    assert sorted(got) == sorted(want) == ["blocks.attn.attn." + n for n in
                                           ("lora_A", "lora_B", "lora_mask", "lora_scale")]
    for n in want:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        if n.endswith(("lora_scale", "lora_mask")):
            np.testing.assert_array_equal(got[n], want[n])
    _, delta = lora.split_lora_state(state.params)
    for n, t in _flat(to_numpy_params(delta)).items():
        np.testing.assert_array_equal(got[n], t)
    assert (tmp_path / "t" / "metrics.csv").is_file()


def test_checkpoint_formats_round_trip(tmp_path):
    flat = {"a": torch.randn(3, 4).to(torch.bfloat16), "b": torch.arange(5, dtype=torch.uint8),
            "c": torch.tensor(2.5), "d": np.arange(6, dtype=np.int8).reshape(2, 3),
            "e": torch.zeros((0, 2))}
    for name in ("w.safetensors", "w.pth"):
        save_flat_checkpoint(flat, tmp_path / name)
        back = load_flat_checkpoint(tmp_path / name)
        assert sorted(back) == sorted(flat)
        for k, v in flat.items():
            v = torch.as_tensor(v)
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    np.testing.assert_array_equal(load_file(str(tmp_path / "w.safetensors"))["d"], flat["d"])
    with pytest.raises(NotImplementedError):
        save_flat_checkpoint(flat, tmp_path / "w.npy")


def test_setup_refuses_what_is_not_ported(tmp_path, tiny_registry):
    """dp (A8) trains on a mesh now (tests/test_torch_train_mesh.py): started
    alone it is refused with the torchrun line; method="adapter" now runs
    (tests/test_torch_adapter.py holds it against the JAX package), and so
    does gptq_calib (tests/test_torch_gptq_packed.py)."""
    base = dict(model_name="tiny-llama", data_path=tmp_path / "x.npz", device="cpu",
                io=IOArgs(out_dir=tmp_path))
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m "
                       "fastmax_tpu_torch.training.finetune"):
        finetune.setup(**{**base, "dp": 2})
    np.savez(base["data_path"], examples=np.array(_sft_examples(4, 20, 60), dtype=object))
    state = finetune.setup(**{**base, "method": "adapter", "adapter_start_layer": 1,
                              "train": TrainArgs(global_batch_size=2, micro_batch_size=2,
                                                 max_iters=1, max_seq_length=64)})
    assert state.step == 1 and (tmp_path / "adapter_weights.safetensors").is_file()
    with pytest.raises(FileNotFoundError, match="lit_config.json"):  # checkpoint_dir is ported
        finetune.setup(**{**base, "checkpoint_dir": tmp_path})
    with pytest.raises(ValueError):
        finetune.setup(**{**base, "method": "full", "quantize": "bnb.nf4"})
