"""Gemma's GeGLU MLP and Mixtral's top-k MoE in the port (models/gpt.py
``apply_mlp``/``apply_moe``, inference/engine.py and continuous.py) against the JAX package on
the CPU, on the same weights (the JAX package's, brought over by
``from_numpy_params``).

The configurations are tests/test_against_hf_more.py's: 2 layers, 64 wide, 8
heads; Gemma with one KV group (MQA, head size 8, scaled embeddings, exact
GELU, RMSNorm with unit offset), Mixtral with 2 groups and 4 experts, top 2.
Tolerances, float32: logits atol 1e-4; the sorted MoE route against the dense
one atol 2e-5 / rtol 1e-4 (tests/test_moe_dispatch.py); gradients 1e-4 of
their largest entry; greedy tokens equal (a divergence passes only at a
near-tie of the top two logits, 1e-4). LoRA on both families and their HF
checkpoints are held in tests/test_torch_family_peft.py.

The ``cuda`` test repeats the sorted route on the card bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.inference.continuous import ContinuousBatcher as JaxBatcher
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
from fastmax_tpu_torch.inference.engine import InferenceEngine, _fuse_mlp_gates
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.training.step import tree_leaves

torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)

COMMON = dict(block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2, n_head=8,
              n_embd=64, rotary_percentage=1.0, parallel_residual=False, bias=False,
              _norm_class="RMSNorm", intermediate_size=112, norm_eps=1e-5)
FAMILIES = {
    "gemma": dict(COMMON, name="Gemma-tiny", n_query_groups=1, _mlp_class="GemmaMLP",
                  scale_embeddings=True),
    "mixtral": dict(COMMON, name="mixtral-tiny", n_query_groups=2, _mlp_class="LLaMAMoE",
                    n_expert=4, n_expert_per_token=2),
}
# a 4-bit base takes blocks of 64 input rows: mlp.proj's 112 becomes 128
QUANT_WIDTH = dict(intermediate_size=128)
NEAR_TIE = 1e-4
PROMPT, NEW = 8, 8


def _conf(family: str, quantize=None) -> dict:
    return {**FAMILIES[family], **(QUANT_WIDTH if quantize else {})}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_params(family: str, seed: int = 0, quantize=None):
    jcfg = JaxConfig(**_conf(family, quantize))
    params = jgpt.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if quantize:
        params = jquant.quantize_model(params, quantize)
    return jcfg, jax.tree.map(np.asarray, params)


def _tokens(seed=0, shape=(2, 13)):
    return np.random.default_rng(seed).integers(0, 90, size=shape)


def _mlp_layer(seed=0):
    """Layer 0 of a Mixtral-tiny MLP and an input, as numpy."""
    _, jp = _jax_params("mixtral", seed)
    mlp = jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"])
    x = np.random.default_rng(seed + 1).standard_normal((2, 10, 64)).astype(np.float32)
    return mlp, x


# ------------------------------------------------------------------ model level


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_params_has_the_jax_layout(family):
    _, jp = _jax_params(family)
    tp = gpt.init_params(Config(**FAMILIES[family]), 0, torch.float32, "cpu")
    want = {k: v.shape for k, v in _flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in _flat(to_numpy_params(tp)).items()} == want
    if family == "mixtral":
        assert want["blocks.mlp.experts.fc_1.kernel"] == (2, 4, 64, 112)
        assert "bias" not in tp["blocks"]["mlp"]["gate"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax(family):
    """The no-cache forward and the cached one (prefill, then one decode
    step per token) against the JAX package's, f32 atol 1e-4."""
    jcfg, jp = _jax_params(family)
    cfg = Config(**FAMILIES[family])
    tp = from_numpy_params(jp, "cpu")
    tok = _tokens()
    want, _ = jgpt.forward(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(tok, jnp.int32))
    got, _ = gpt.forward(tp, cfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    cache = gpt.init_kv_cache(cfg, 2, 64, torch.float32, "cpu")
    pre, cache = gpt.forward(tp, cfg, torch.from_numpy(tok[:, :9]), input_pos=0, kv_cache=cache)
    steps = [pre]
    for pos in range(9, 13):
        step, cache = gpt.forward(tp, cfg, torch.from_numpy(tok[:, pos:pos + 1]), input_pos=pos,
                                  kv_cache=cache)
        steps.append(step)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_gemma_gelu_is_exact_and_fuses():
    """GeGLU takes the exact GELU (the tanh form moves the logits), and the
    fused fc_12 gives the unfused forward."""
    _, jp = _jax_params("gemma")
    cfg = Config(**FAMILIES["gemma"])
    tp = from_numpy_params(jp, "cpu")
    tok = torch.from_numpy(_tokens(1))
    a, _ = gpt.forward(tp, cfg, tok)
    fused = _fuse_mlp_gates(tp)
    assert "fc_12" in fused["blocks"]["mlp"]
    b, _ = gpt.forward(fused, cfg, tok)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)
    tanh = Config(**{**FAMILIES["gemma"], "_mlp_class": "GptNeoxMLP"})
    mlp = {"fc": tp["blocks"]["mlp"]["fc_1"], "proj": tp["blocks"]["mlp"]["proj"]}
    x = torch.randn(1, 4, 64)
    exact = gpt.apply_mlp(mlp, x, tanh, 0)
    tanh.gelu_approximate = "tanh"
    assert not torch.equal(gpt.apply_mlp(mlp, x, tanh, 0), exact)


# ------------------------------------------------------------------ MoE dispatch


def test_moe_sorted_matches_dense_and_jax():
    mlp, x = _mlp_layer()
    cfg, jcfg = Config(**FAMILIES["mixtral"]), JaxConfig(**FAMILIES["mixtral"])
    tm, tx = from_numpy_params(mlp, "cpu"), torch.from_numpy(x)
    dense = gpt.apply_moe(tm, tx, cfg, sorted_dispatch=False)
    reads = gpt.MOE_HOST_READS[0]
    sorted_ = gpt.apply_moe(tm, tx, cfg, sorted_dispatch=True)
    assert gpt.MOE_HOST_READS[0] == reads + 1
    np.testing.assert_allclose(sorted_.numpy(), dense.numpy(), atol=2e-5, rtol=1e-4)
    for route in (True, False):
        want = jgpt.apply_moe(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x), jcfg,
                              sorted_dispatch=route)
        got = sorted_ if route else dense
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_moe_dense_route_takes_expert_biases():
    """Experts with biases take the dense route in both packages."""
    mlp, x = _mlp_layer(2)
    rng = np.random.default_rng(3)
    for name in ("fc_1", "fc_2", "proj"):
        k = mlp["experts"][name]["kernel"]
        mlp["experts"][name]["bias"] = (rng.standard_normal((k.shape[0], k.shape[2])) * 0.1
                                        ).astype(np.float32)
    cfg, jcfg = Config(**FAMILIES["mixtral"]), JaxConfig(**FAMILIES["mixtral"])
    reads = gpt.MOE_HOST_READS[0]
    got = gpt.apply_moe(from_numpy_params(mlp, "cpu"), torch.from_numpy(x), cfg)
    assert gpt.MOE_HOST_READS[0] == reads
    want = jgpt.apply_moe(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("route", ["sorted", "dense"])
def test_moe_gradients_match_jax(route):
    """d sum(y^2) by every MLP leaf and by x, each within 1e-4 of its largest
    entry of the JAX package's (its sorted route through lax.ragged_dot)."""
    mlp, x = _mlp_layer(4)
    cfg, jcfg = Config(**FAMILIES["mixtral"]), JaxConfig(**FAMILIES["mixtral"])
    sd = route == "sorted"
    jg = jax.grad(lambda m, xx: jnp.sum(jgpt.apply_moe(m, xx, jcfg, sorted_dispatch=sd) ** 2),
                  argnums=(0, 1))(jax.tree.map(jnp.asarray, mlp), jnp.asarray(x))
    tm, tx = from_numpy_params(mlp, "cpu"), torch.from_numpy(x).requires_grad_(True)
    for p in tree_leaves(tm):
        p.requires_grad_(True)
    (gpt.apply_moe(tm, tx, cfg, sorted_dispatch=sd) ** 2).sum().backward()
    want = _flat(jax.tree.map(np.asarray, jg[0]))
    got = {n: p.grad.numpy() for n, p in zip(_flat(mlp), tree_leaves(tm))}
    want["x"], got["x"] = np.asarray(jg[1]), tx.grad.numpy()
    assert sorted(got) == sorted(want)
    for n in want:
        scale = float(np.abs(want[n]).max())
        assert scale > 0, n
        np.testing.assert_allclose(got[n], want[n], atol=1e-4 * scale, rtol=0, err_msg=n)


def test_moe_stacked_layer_mode_slices_every_leaf():
    """apply_mlp with ``layer`` equals apply_moe on that layer's slice."""
    _, jp = _jax_params("mixtral", 5)
    cfg = Config(**FAMILIES["mixtral"])
    tmlp = from_numpy_params(jp["blocks"]["mlp"], "cpu")
    x = torch.randn(1, 6, 64)
    one = jax.tree.map(lambda a: a[1], jp["blocks"]["mlp"])
    np.testing.assert_array_equal(gpt.apply_mlp(tmlp, x, cfg, 1).numpy(),
                                  gpt.apply_moe(from_numpy_params(one, "cpu"), x, cfg).numpy())


# ------------------------------------------------------------------ serving


def _margins(engine, seq: np.ndarray) -> np.ndarray:
    cache = engine.new_cache()
    with torch.inference_mode():
        logits, cache = engine._forward(torch.from_numpy(seq[:, :PROMPT]), cache, 0)
        rows = [logits[0, -1]]
        for pos in range(PROMPT, seq.shape[1] - 1):
            logits, cache = engine._forward(torch.from_numpy(seq[:, pos:pos + 1]), cache, pos)
            rows.append(logits[0, -1])
    top2 = torch.topk(torch.stack(rows).float(), 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


@pytest.mark.parametrize("mode", ["preload", "preload_int4", "quantized"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_matches_jax(family, mode):
    """Greedy tokens of the port's engine equal the JAX engine's on a
    bnb.nf4 base in three weights modes; the prefill logits agree within
    1e-4; the experts stay dense in every mode, as in the reference."""
    jcfg, jp = _jax_params(family, quantize="bnb.nf4")
    cfg = Config(**_conf(family, "bnb.nf4"))
    tp = from_numpy_params(jp, "cpu")
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, jp), max_seq_length=64, weights_mode=mode)
    teng = InferenceEngine(cfg, tp, max_seq_length=64, weights_mode=mode, device="cpu")
    mlp = teng.params["blocks"]["mlp"]
    if family == "mixtral":
        assert set(mlp["experts"]["fc_1"]) == {"kernel"}
        assert ("q4r1" if mode == "preload_int4" else "kernel" if mode == "preload" else "q4") \
            in mlp["gate"]
    else:
        assert "fc_12" in mlp
    prompt = np.random.default_rng(0).integers(1, 90, (PROMPT,)).astype(np.int32)
    jl, _ = jeng._chunked_prefill(jnp.asarray(prompt)[None], jeng.new_cache())
    tl, _ = teng.prefill(torch.from_numpy(prompt)[None], teng.new_cache())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    ref = np.array(jeng.generate(jnp.asarray(prompt), PROMPT + NEW, temperature=0.0,
                                 key=jax.random.PRNGKey(0)))
    got = teng.generate(torch.from_numpy(prompt), PROMPT + NEW).numpy()
    diff = np.nonzero(got[0, PROMPT:] != ref[0, PROMPT:])[0]
    if diff.size:
        margin = _margins(teng, ref)[int(diff[0])]
        assert margin < NEAR_TIE, f"tokens diverge at step {diff[0]}, margin {margin:.2e}"
    else:
        np.testing.assert_array_equal(got, ref)


def test_weights_modes_keep_the_experts_dense():
    """Every weights mode leaves the MoE experts dense and equal to the
    reference's prepared tree; the router takes the mode."""
    from fastmax_tpu.inference.engine import InferenceEngine as JEng

    _, jp = _jax_params("mixtral", quantize="bnb.nf4")
    tp = from_numpy_params(jp, "cpu")
    for mode in ("quantized", "preload", "preload_int8", "preload_int4", "preload_int4_block",
                 "auto"):
        want = _flat(jax.tree.map(np.asarray, JEng.prepare_params(
            jax.tree.map(jnp.asarray, jp), "preload_int4" if mode == "auto" else mode)))
        got = _flat(to_numpy_params(InferenceEngine.prepare_params(tp, mode)))
        assert sorted(got) == sorted(want), mode
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=f"{mode} {n}")
        assert not any(n.startswith("blocks.mlp.experts") and not n.endswith("kernel")
                       for n in got)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batcher_matches_jax(family):
    """The batcher's greedy tokens equal the JAX batcher's on the same
    bnb.nf4 tree in preload_int4 with an int8 cache: four requests in two
    buckets, one of them behind a registered prefix, three slots (a slot is
    reused); the MoE layers see rows of several slots at once."""
    jcfg, jp = _jax_params(family, 1, quantize="bnb.nf4")
    cfg = Config(**_conf(family, "bnb.nf4"))
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 90, (6,)).astype(np.int32)
    prompts = [rng.integers(1, 90, (n,)).astype(np.int32) for n in (9, 14, 5)]
    prompts.append(np.concatenate([prefix, rng.integers(1, 90, (4,)).astype(np.int32)]))

    def run(b):
        b.register_prefix(prefix)
        rids = [b.submit(p, NEW) for p in prompts]
        res = b.run_to_completion()
        return [res[r] for r in rids]

    kw = dict(n_slots=3, max_seq_length=64, weights_mode="preload_int4", prefix_cache_size=4)
    got = run(ContinuousBatcher(cfg, from_numpy_params(jp, "cpu"), cache_dtype=torch.int8,
                                device="cpu", **kw))
    want = run(JaxBatcher(jcfg, jax.tree.map(jnp.asarray, jp), cache_dtype=jnp.int8, **kw))
    assert got == want


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_sorted_dispatch_repeats_bit_for_bit_on_the_card():
    """The sorted route combines without atomics: two runs on the card give
    the same bits, and it agrees with the dense route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = Config(**{**FAMILIES["mixtral"], "n_embd": 512, "intermediate_size": 1024,
                    "n_expert": 8})
    p = gpt.init_params(cfg, 0, torch.bfloat16, "cuda")
    mlp = {k: v for k, v in gpt._slice_tree(p["blocks"]["mlp"], 0).items()}
    x = torch.randn(4, 256, 512, device="cuda", dtype=torch.bfloat16)
    a = gpt.apply_moe(mlp, x, cfg)
    b = gpt.apply_moe(mlp, x, cfg)
    assert torch.equal(a, b)
    dense = gpt.apply_moe(mlp, x, cfg, sorted_dispatch=False)
    assert float((a.float() - dense.float()).abs().max()) <= 2e-2 * float(dense.abs().max())
