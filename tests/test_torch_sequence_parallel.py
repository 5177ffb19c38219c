"""Ring attention and sequence-parallel training in the port
(fastmax_tpu_torch/parallel/ring_attention.py, sequence_parallel.py) on four
gloo ranks on the CPU, mirroring tests/test_ring_attention.py and
tests/test_sequence_parallel.py against the JAX package.

One group of ranks (collectives.spawn_local over torch_rank_checks.run_cases)
runs every case. Tolerances are the reference tests': the ring against full
causal attention atol 2e-5, rtol 1e-4 (its gradients against dense autograd
the same, relative to the largest entry); the sp forward against the JAX
dense forward atol 2e-4, rtol 1e-3; the sp loss within 5e-3 of the dense
loss on the same stream (the reference's bound), and here also within 1e-5
relative with its gradients within 1e-4 of each leaf's largest entry (the
sums of one function in another order); the three-way loss likewise.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.utils.loss import cross_entropy as jcross_entropy
from fastmax_tpu_torch.parallel import collectives as col

WORLD = 4
SP = dict(name="sp-test", block_size=128, vocab_size=96, padded_vocab_size=96, n_layer=2,
          n_head=4, n_embd=64, n_query_groups=2, rotary_percentage=1.0,
          parallel_residual=False, bias=False, _norm_class="RMSNorm", _mlp_class="LLaMAMLP",
          intermediate_size=128)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def dense_attention(q, k, v):
    """Full causal softmax attention in float64 with autograd (GQA by
    repeating the KV heads)."""
    q, k, v = (torch.as_tensor(x, dtype=torch.float64) for x in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    n = q.shape[2]
    s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), float("-inf"))
    return torch.softmax(s, -1) @ v


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal((2, 4, 128, 32)).astype(np.float32) for _ in range(3)]
    gqa = [rng.standard_normal(s).astype(np.float32)
           for s in ((1, 8, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16))]
    grad_out = rng.standard_normal((2, 4, 128, 32)).astype(np.float32)
    jcfg = JaxConfig(**SP)
    params = np_tree(jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = rng.integers(0, 96, (2, 65))
    cases = [(f"ring_{p}", "ring_case", dict(q=qkv[0], k=qkv[1], v=qkv[2],
                                              mesh=(WORLD // p, 1, p)))
             for p in (2, 4)]
    from fastmax_tpu_torch.ops.attention import repeat_kv_heads

    cases.append(("ring_gqa", "ring_case", dict(
        q=gqa[0], k=repeat_kv_heads(torch.as_tensor(gqa[1]), 8).numpy(),
        v=repeat_kv_heads(torch.as_tensor(gqa[2]), 8).numpy(), mesh=(2, 1, 2))))
    cases.append(("ring_grad", "ring_case", dict(q=qkv[0], k=qkv[1], v=qkv[2], mesh=(1, 1, 4),
                                                 grad_out=grad_out)))
    for p in (2, 4):
        cases.append((f"fwd_{p}", "sp_case", dict(cfg=SP, params=params, batch=batch,
                                                   mesh=(WORLD // p, 1, p), what="forward")))
    cases.append(("loss", "sp_case", dict(cfg=SP, params=params, batch=batch, mesh=(2, 1, 2),
                                          what="loss")))
    cases.append(("step", "sp_case", dict(cfg=SP, params=params, batch=batch, mesh=(1, 1, 4),
                                          what="step")))
    cases.append(("refuse", "sp_case", dict(cfg=SP, params=params, batch=batch,
                                            mesh=(1, 1, 4), what="refuse")))
    cases.append(("three_way", "sp_case", dict(cfg=SP, params=params, batch=batch,
                                               mesh=(2, 1, 2), what="three_way")))
    cases.append(("three_way_fsdp", "sp_case", dict(cfg=SP, params=params, batch=batch,
                                                    mesh=(2, 2, 1), what="three_way")))

    import torch_rank_checks as rank_checks

    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(col.spawn_local, rank_checks.run_cases, WORLD, args=(cases,),
                        timeout=300)
    pool.shutdown(wait=False)
    return {"ranks": ranks, "qkv": qkv, "gqa": gqa, "grad_out": grad_out, "jcfg": jcfg,
            "params": params, "batch": batch}


def result(world) -> dict:
    return world["ranks"].result()[0]


@pytest.mark.parametrize("p", [2, 4])
def test_ring_matches_full_causal(world, p):
    ref = dense_attention(*world["qkv"]).numpy()
    np.testing.assert_allclose(result(world)[f"ring_{p}"]["out"], ref, atol=2e-5, rtol=1e-4)


def test_ring_gqa_via_expanded_heads(world):
    """GQA inputs: the KV heads expanded before the split (the ring runs on
    whole heads)."""
    ref = dense_attention(*world["gqa"]).numpy()
    np.testing.assert_allclose(result(world)["ring_gqa"]["out"], ref, atol=2e-5, rtol=1e-4)


def test_ring_gradients_match_dense_autograd(world):
    """The ring's backward (the reverse shifts) against dense autograd."""
    q, k, v = (torch.as_tensor(x, dtype=torch.float64).requires_grad_(True)
               for x in world["qkv"])
    (dense_attention(q, k, v) * torch.as_tensor(world["grad_out"], dtype=torch.float64)) \
        .sum().backward()
    got = result(world)["ring_grad"]
    for name, x in (("dq", q), ("dk", k), ("dv", v)):
        ref = x.grad.numpy()
        np.testing.assert_allclose(got[name], ref, atol=2e-5 * np.abs(ref).max(), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("p", [2, 4])
def test_sp_forward_matches_the_jax_dense_forward(world, p):
    idx = jnp.asarray(world["batch"][:, :-1])
    ref, _ = jgpt.forward(jax.tree.map(jnp.asarray, world["params"]), world["jcfg"], idx)
    np.testing.assert_allclose(result(world)[f"fwd_{p}"], np.asarray(ref), atol=2e-4,
                               rtol=1e-3)


def dense_loss(world):
    """The JAX dense loss over the sharded stream batch[:, :-1] (next-token
    targets inside it) and its gradients."""
    stream = jnp.asarray(world["batch"][:, :-1])

    def loss(params):
        logits, _ = jgpt.forward(params, world["jcfg"], stream)
        return jcross_entropy(logits[:, :-1], stream[:, 1:])

    value, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, world["params"]))
    return float(value), flat(np_tree(grads))


def assert_loss_and_grads(got, world):
    value, grads = dense_loss(world)
    assert abs(got["loss"] - value) < 5e-3  # the reference's bound
    np.testing.assert_allclose(got["loss"], value, rtol=1e-5)
    assert sorted(got["grads"]) == sorted(grads)
    for name, w in grads.items():
        np.testing.assert_allclose(got["grads"][name], w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_sp_loss_and_gradients_match_dense(world):
    """make_sp_loss_fn at P 2 (a data axis of 2 beside it): the neighbour's
    first token is the chunk's last target, the global last token is masked."""
    assert_loss_and_grads(result(world)["loss"], world)


def test_sp_train_step_learns(world):
    losses = result(world)["step"]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]


def test_sp_refuses_the_linear_arms(world):
    assert "softmax (quadratic) attention" in result(world)["refuse"]


@pytest.mark.parametrize("case", ["three_way", "three_way_fsdp"])
def test_sp_tp_fsdp_loss_matches_dense(world, case):
    """The three-way composition: the ring over data x tp over model (2, 1, 2),
    and the ring over data x fsdp (2, 2, 1): the dense loss and gradients."""
    got = result(world)[case]
    assert_loss_and_grads(got, world)
    assert got["specs"]["blocks"]["attn"]["attn"]["kernel"][-1] == \
        ("model" if case == "three_way" else "fsdp")
