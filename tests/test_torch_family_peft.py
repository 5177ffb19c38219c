"""LoRA on Gemma's GeGLU MLP and on Mixtral's MoE router (models/lora.py,
``lora.mlp``) and HF checkpoints of both families through the converter
(scripts/convert_hf_checkpoint.py), against the JAX package on the CPU.

The configurations are those of tests/test_torch_model_families.py (after
tests/test_against_hf_more.py). Tolerances, float32: the SFT loss rtol 1e-5,
each LoRA gradient 1e-3 of its largest entry (tests/test_torch_finetune.py),
merges bit for bit into quantized bases and within 1e-6 into dense ones, and
HF's logits within tests/test_against_hf_more.py's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.models import config as jconfig_mod
from fastmax_tpu.models import lora as jlora
from fastmax_tpu.scripts import convert_hf_checkpoint as jconv
from fastmax_tpu.training import finetune as jfinetune
from fastmax_tpu.training import fit as jfit
from fastmax_tpu_torch.models import config as tconfig_mod
from fastmax_tpu_torch.models import gpt, lora
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.scripts import convert_hf_checkpoint as tconv
from fastmax_tpu_torch.training import finetune
from fastmax_tpu_torch.training.step import tree_leaves
from fastmax_tpu_torch.utils.checkpoint import load_model_params
from tests.test_torch_model_families import FAMILIES, _conf, _flat, _jax_params, _tokens

torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)


# ------------------------------------------------------------------ LoRA


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lora_on_the_mlp_matches_jax(family):
    """``lora.mlp`` on Gemma's fc_1/fc_2/proj and on Mixtral's router: the
    leaves, their shapes and the trainable mask equal the JAX package's; on
    an NF4 base with the JAX leaves brought over (lora_B drawn so that every
    delta reaches the loss), the SFT loss (rtol 1e-5) and every LoRA
    gradient (1e-3 of its largest) agree; merge_lora into the NF4 base
    equals the JAX merge bit for bit."""
    jcfg, jp = _jax_params(family, 2, quantize="bnb.nf4")
    cfg = Config(**_conf(family, "bnb.nf4"))
    lc = dict(mlp=True)
    jl = jlora.add_lora_params(jax.tree.map(jnp.asarray, jp), jcfg, jlora.LoRAConfig(**lc),
                               jax.random.PRNGKey(3))
    jl = jax.tree.map(np.asarray, jl)
    rng = np.random.default_rng(4)
    for name, a in _flat(jl).items():
        if name.endswith("lora_B"):
            *path, leaf = name.split(".")
            node = jl
            for k in path:
                node = node[k]
            node[leaf] = (rng.standard_normal(a.shape) * 0.05).astype(np.float32)
    tl = lora.add_lora_params(from_numpy_params(jp, "cpu"), cfg, lora.LoRAConfig(**lc),
                              torch.Generator().manual_seed(3))
    assert {k: v.shape for k, v in _flat(to_numpy_params(tl)).items()} == \
        {k: v.shape for k, v in _flat(jl).items()}
    assert _flat(lora.trainable_mask(tl)) == _flat(jlora.trainable_mask(jl))
    mlp_lora = [n for n in _flat(jl) if n.startswith("blocks.mlp") and n.endswith("lora_A")]
    assert mlp_lora == (["blocks.mlp.gate.lora_A"] if family == "mixtral" else
                        [f"blocks.mlp.{k}.lora_A" for k in ("fc_1", "fc_2", "proj")])

    tp = from_numpy_params(jl, "cpu")
    inputs = np.random.default_rng(5).integers(0, 96, (2, 24))
    labels = inputs.copy()
    labels[:, :6] = -1
    jloss, jgrads = jfit.value_and_grad_floats(jfinetune.sft_loss_fn(jcfg), jax.tree.map(
        jnp.asarray, jl), (jnp.asarray(inputs, jnp.int32), jnp.asarray(labels, jnp.int32)))
    for p, m in zip(tree_leaves(tp), tree_leaves(lora.trainable_mask(tp))):
        p.requires_grad_(m)
    loss = finetune.sft_loss_fn(cfg)(tp, (torch.from_numpy(inputs), torch.from_numpy(labels)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad.numpy() for n, p in zip(_flat(jl), tree_leaves(tp)) if p.grad is not None}
    assert sorted(got) == sorted(n for n in _flat(jl) if n.endswith(("lora_A", "lora_B")))
    for n, g in got.items():
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(g, want[n], atol=1e-3 * scale, err_msg=n)

    merged = _flat(to_numpy_params(lora.merge_lora(from_numpy_params(jl, "cpu"))))
    jmerged = _flat(jax.tree.map(np.asarray, jlora.merge_lora(jax.tree.map(jnp.asarray, jl))))
    assert sorted(merged) == sorted(jmerged)
    for n in jmerged:
        np.testing.assert_array_equal(merged[n], jmerged[n], err_msg=n)


@pytest.mark.parametrize("mode", ["dense", "bnb.int8"])
def test_lora_merge_on_the_gemma_mlp(mode):
    """The dense and int8 merges of LoRA on Gemma's MLP equal the JAX
    package's (dense: 1e-6; int8: the requantized codes bit for bit)."""
    jcfg, jp = _jax_params("gemma", 3, quantize=None if mode == "dense" else mode)
    jl = jax.tree.map(np.asarray, jlora.add_lora_params(
        jax.tree.map(jnp.asarray, jp), jcfg, jlora.LoRAConfig(mlp=True), jax.random.PRNGKey(1)))
    for k in ("fc_1", "fc_2", "proj"):
        b = jl["blocks"]["mlp"][k]["lora_B"]
        jl["blocks"]["mlp"][k]["lora_B"] = np.full(b.shape, 0.01, np.float32)
    want = _flat(jax.tree.map(np.asarray, jlora.merge_lora(jax.tree.map(jnp.asarray, jl))))
    got = _flat(to_numpy_params(lora.merge_lora(from_numpy_params(jl, "cpu"))))
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-6 if mode == "dense" else 0, rtol=0,
                                   err_msg=n)


# ------------------------------------------------------------------ HF checkpoints


def _hf_model(family: str):
    import transformers

    c = FAMILIES[family]
    common = dict(vocab_size=c["vocab_size"], hidden_size=c["n_embd"],
                  num_attention_heads=c["n_head"], num_key_value_heads=c["n_query_groups"],
                  num_hidden_layers=c["n_layer"], intermediate_size=c["intermediate_size"],
                  max_position_embeddings=64, rms_norm_eps=1e-5, attn_implementation="eager",
                  tie_word_embeddings=False)
    torch.manual_seed(3)
    if family == "gemma":
        model = transformers.GemmaForCausalLM(transformers.GemmaConfig(
            head_dim=8, hidden_act="gelu", hidden_activation="gelu", **common))
    else:
        model = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            num_local_experts=4, num_experts_per_tok=2, **common))
    return model.eval()


@pytest.fixture
def registries(monkeypatch):
    for mod in (jconfig_mod, tconfig_mod):
        reg = dict(mod.registry())
        reg.update({c["name"]: dict(c) for c in FAMILIES.values()})
        monkeypatch.setattr(mod, "registry", lambda reg=reg: reg)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hf_checkpoint_converts_and_loads(tmp_path, registries, family):
    """A tiny HF Gemma and Mixtral written by save_pretrained, converted by
    both packages' converters to the same tensors, loaded by the port and
    run to HF's logits (the tolerances of tests/test_against_hf_more.py)."""
    model = _hf_model(family)
    src = tmp_path / "hf"
    model.save_pretrained(src)
    name = FAMILIES[family]["name"]
    jconv.convert_hf_checkpoint(src, model_name=name, out_dir=tmp_path / "jax")
    out = tconv.convert_hf_checkpoint(src, model_name=name, out_dir=tmp_path / "port")
    cfg, params = load_model_params(out, device="cpu")
    _, jparams = load_model_params(tmp_path / "jax", device="cpu")
    for n, want in _flat(to_numpy_params(jparams)).items():
        np.testing.assert_array_equal(_flat(to_numpy_params(params))[n], want, err_msg=n)
    tok = _tokens(0, (2, 13))
    with torch.no_grad():
        ref = model(torch.from_numpy(tok)).logits.numpy()
        ours, _ = gpt.forward(params, cfg, torch.from_numpy(tok))
    tol = dict(atol=1e-3, rtol=1e-2) if family == "gemma" else dict(atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(ours.numpy(), ref, **tol)
