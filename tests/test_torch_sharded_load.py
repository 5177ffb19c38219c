"""The port's checkpoint loads for a mesh (fastmax_tpu_torch/utils/sharded_load.py)
against the JAX package: load_sharded_model_params on four gloo ranks, each
reading only its own slices, for every checkpoint format the JAX package writes
(npy directory, safetensors, lit_model.pth) and for MoE expert stacks; and the
streaming quantized load, bit-identical to quantizing the whole tree
(tests/test_sharding.py:154-292)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.models.params import params_to_flat
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.utils.checkpoint import save_flat_checkpoint
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.parallel import collectives as col
from fastmax_tpu_torch.utils import sharded_load

torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)

SMALL = dict(name="shard-test", block_size=64, vocab_size=128, padded_vocab_size=128,
             n_layer=2, n_head=8, n_embd=64, n_query_groups=4, rotary_percentage=1.0,
             parallel_residual=False, bias=False, _norm_class="RMSNorm", _mlp_class="LLaMAMLP",
             intermediate_size=128)
NEOX = {**SMALL, "bias": True, "_mlp_class": "GptNeoxMLP", "_norm_class": "LayerNorm",
        "intermediate_size": None}
MOE = {**SMALL, "_mlp_class": "LLaMAMoE", "n_expert": 4, "n_expert_per_token": 2,
       "intermediate_size": 96}
FORMATS = {"npy": "", "safetensors": "model.safetensors", "pth": "lit_model.pth"}


def write(d, cfg_kw, fmt):
    cfg = JaxConfig(**cfg_kw)
    params = jgpt.init_params(cfg, jax.random.PRNGKey(0))
    d.mkdir()
    save_flat_checkpoint(params_to_flat(params, cfg), d / FORMATS[fmt] if FORMATS[fmt] else d)
    with open(d / "lit_config.json", "w") as fp:
        json.dump({k: v for k, v in cfg.__dict__.items() if not k.startswith("hf")}, fp,
                  default=str)
    return params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_load")
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128))
    params, cases = {}, []
    for fmt in FORMATS:
        params[fmt] = write(root / fmt, NEOX, fmt)
        cases.append((fmt, "sharded_load", dict(checkpoint_dir=str(root / fmt), tp=2, fsdp=2,
                                                idx=idx)))
    params["moe"] = write(root / "moe", MOE, "npy")
    cases.append(("moe", "sharded_load", dict(checkpoint_dir=str(root / "moe"), tp=4, fsdp=1,
                                              idx=idx[:2])))
    import torch_rank_checks as rank_checks

    res = col.spawn_local(rank_checks.run_cases, 4, args=(cases,), timeout=300)[0]
    return res, params, idx, root


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_sharded_streaming_load_matches_dense(world, fmt):
    """fsdp 2 x model 2: every leaf of each rank equals the same cut of the whole
    load, each rank read less than the checkpoint holds, and the sharded
    forward gives the JAX forward's logits."""
    res, params, idx, root = world
    got = res[fmt]
    assert got["diffs"] and max(got["diffs"].values()) <= 1e-6, got["diffs"]
    total = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(params[fmt]))
    assert all(0 < r < total for r in got["read_bytes"]), (got["read_bytes"], total)
    ref, _ = jgpt.forward(params[fmt], JaxConfig(**NEOX), jnp.asarray(idx))
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_sharded_streaming_load_moe(world):
    """MoE expert stacks (L, E, in, out) assemble lazily from per-expert tensors
    and are cut over the model axis on the expert axis."""
    res, params, idx, _ = world
    got = res["moe"]
    assert max(got["diffs"].values()) <= 1e-6
    want = np.asarray(params["moe"]["blocks"]["mlp"]["experts"]["fc_1"]["kernel"])
    assert got["experts_fc_1"].shape == (2, 4, 64, 96)
    np.testing.assert_allclose(got["experts_fc_1"], want, atol=1e-6)
    ref, _ = jgpt.forward(params["moe"], JaxConfig(**MOE), jnp.asarray(idx[:2]))
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_streaming_quantized_load_matches_in_memory(tmp_path, mode):
    """load_quantized_model_params: the streaming layer-at-a-time quantization is
    bit-identical to the JAX package's quantization of the whole dense model."""
    params = write(tmp_path / "ckpt", SMALL, "npy")
    _, streamed = sharded_load.load_quantized_model_params(tmp_path / "ckpt", mode=mode,
                                                           device="cpu")
    got_attn = streamed["blocks"]["attn"]["attn"]
    if mode == "int8":
        ref_attn = jquant.quantize_model(params, "bnb.int8")["blocks"]["attn"]["attn"]
        for key in ("q8", "scale8"):
            np.testing.assert_array_equal(got_attn[key].numpy(), np.asarray(ref_attn[key]))
    else:
        kern = np.asarray(params["blocks"]["attn"]["attn"]["kernel"], np.float32)
        per_layer = [jquant.quantize_int4_tiled(kern[layer], "rank1")
                     for layer in range(kern.shape[0])]
        for key in per_layer[0]:
            ref = np.stack([np.asarray(p[key]) for p in per_layer])
            np.testing.assert_array_equal(got_attn[key].numpy(), ref, err_msg=key)
    assert streamed["wte"].dtype == torch.bfloat16
    assert "q8" not in streamed["lm_head"] and "kernel" in streamed["lm_head"]
    from fastmax_tpu_torch.models.config import Config

    eng = InferenceEngine(Config(**SMALL), streamed, max_seq_length=32, device="cpu")
    out = eng.generate(torch.arange(1, 6, dtype=torch.int32), 12)
    assert out.shape == (1, 12)
