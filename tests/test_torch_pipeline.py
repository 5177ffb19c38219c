"""GPipe pipeline parallelism in the port (fastmax_tpu_torch/parallel/pipeline.py)
on four gloo ranks on the CPU, mirroring tests/test_pipeline.py against the JAX
package.

The tiny LLaMA of tests/test_pipeline.py (4 layers, 64 wide, 4 heads, 2 query
groups) with the JAX package's weights carried across. One group of ranks
(collectives.spawn_local over torch_rank_checks.run_cases) runs every case
while the JAX side runs on the virtual 8-device mesh. Tolerances are the
reference test's: the loss within 2e-4 of the dense loss (and here also of
the JAX pipeline's), the gradients within atol 3e-4, rtol 2e-3 of jax.grad of
the dense loss.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.parallel import pipeline as jpp
from fastmax_tpu.parallel.sharding import make_mesh as jmake_mesh
from fastmax_tpu.parallel.sharding import shard_params as jshard_params
from fastmax_tpu.training.step import make_loss_fn as jmake_loss_fn
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.parallel import collectives as col
from fastmax_tpu_torch.parallel import pipeline as pp

WORLD = 4
PP = dict(name="pp-test", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=4,
          n_head=4, n_embd=64, n_query_groups=2, rotary_percentage=1.0,
          parallel_residual=False, bias=False, _norm_class="RMSNorm", _mlp_class="LLaMAMLP",
          intermediate_size=128)
LOSS_CASES = [(2, 2), (4, 4), (4, 2)]
GRAD_MESHES = {"grads_4": (1, 1, 4), "grads_data": (2, 1, 2)}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def world():
    jcfg = JaxConfig(**PP)
    jparams = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jparams)
    batch = np.random.default_rng(1).integers(0, 96, (4, 33))
    cases = [(f"loss_{p}_{m}", "pp_case", dict(cfg=PP, params=params, batch=batch,
                                                mesh=(WORLD // p, 1, p), what="loss", n_micro=m))
             for p, m in LOSS_CASES]
    cases += [(name, "pp_case", dict(cfg=PP, params=params, batch=batch, mesh=mesh,
                                     what="grads", n_micro=2))
              for name, mesh in GRAD_MESHES.items()]
    cases.append(("fsdp", "pp_case", dict(cfg=PP, params=params, batch=batch, mesh=(1, 2, 2),
                                          what="fsdp", n_micro=2)))
    cases.append(("step", "pp_case", dict(cfg=PP, params=params, batch=batch, mesh=(1, 1, 4),
                                          what="step", n_micro=2)))
    cases.append(("refuse", "pp_case", dict(cfg=PP, params=None, batch=None, mesh=(2, 1, 2),
                                            what="refuse", n_micro=2)))

    import torch_rank_checks as rank_checks

    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(col.spawn_local, rank_checks.run_cases, WORLD, args=(cases,),
                        timeout=300)
    pool.shutdown(wait=False)
    jbatch = jnp.asarray(batch)
    dense_fn = jmake_loss_fn(jcfg, remat=False)
    dense, grads = jax.value_and_grad(dense_fn)(jparams, jbatch)
    return {"ranks": ranks, "jcfg": jcfg, "jparams": jparams, "params": params,
            "batch": jbatch, "dense": float(dense), "grads": flat(jax.tree.map(np.asarray, grads))}


def result(world, name):
    return world["ranks"].result()[0][name]


def jax_pp_loss(world, p, n_micro, fsdp=1):
    """The JAX package's pipeline loss on its virtual mesh."""
    jcfg, jparams = world["jcfg"], world["jparams"]
    mesh = jmake_mesh(data=8 // (p * fsdp), fsdp=fsdp, model=p)
    if fsdp == 1:
        specs, kw = jpp.pp_param_specs(jcfg, jparams, axis="model"), {}
    else:
        specs = jpp.pp_fsdp_param_specs(jcfg, jparams, axis="model", fsdp_axis="fsdp",
                                        fsdp_size=fsdp)
        kw = dict(fsdp_specs=specs, fsdp_axis="fsdp")
    loss_fn = jpp.make_pp_loss_fn(jcfg, mesh, axis="model", n_micro=n_micro, **kw)
    with mesh:
        return float(jax.jit(loss_fn)(jshard_params(jparams, mesh, specs), world["batch"]))


def assert_grads(got, world):
    want = world["grads"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=3e-4, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("p,n_micro", LOSS_CASES)
def test_pp_loss_matches_dense_and_jax_pipeline(world, p, n_micro):
    got = result(world, f"loss_{p}_{n_micro}")
    assert abs(got - world["dense"]) < 2e-4, (got, world["dense"])
    assert abs(got - jax_pp_loss(world, p, n_micro)) < 2e-4


@pytest.mark.parametrize("case", sorted(GRAD_MESHES))
def test_pp_grads_match_dense(world, case):
    """The stages' block gradients concatenated in stage order against
    jax.grad of the dense loss, at P = 4 and on a (2, 1, 2) mesh (its data
    replicas compute the same); the leaves outside ``blocks`` summed over the
    stages are equal on every rank."""
    got = result(world, case)
    assert abs(got["loss"] - world["dense"]) < 2e-4
    assert_grads(got["grads"], world)
    reps = [r[case]["replicated"] for r in world["ranks"].result()]
    assert sorted(reps[0]) == ["lm_head.kernel", "ln_f.weight", "wte"]
    for other in reps[1:]:
        for name, g in reps[0].items():
            np.testing.assert_array_equal(other[name], g, err_msg=name)


def test_pp_fsdp_matches_dense_and_jax(world):
    """pp + fsdp on (1, 2, 2): the blocks split over the stages and over fsdp,
    gathered at stage entry; loss and whole gradients as dense, the loss as
    the JAX pp+fsdp loss on (2, 2, 2)."""
    got = result(world, "fsdp")
    assert abs(got["loss"] - world["dense"]) < 2e-4
    assert abs(got["loss"] - jax_pp_loss(world, 2, 2, fsdp=2)) < 2e-4
    assert_grads(got["grads"], world)


def test_pp_train_step_learns(world):
    """Three AdamW steps (the reference test's optax.adamw(5e-3)): the first
    loss is the dense one, the loss falls, and each step's loss is the JAX
    pipeline step's."""
    losses = result(world, "step")
    assert abs(losses[0] - world["dense"]) < 2e-4
    assert np.isfinite(losses[0]) and losses[2] < losses[0]
    jcfg = world["jcfg"]
    mesh = jmake_mesh(data=1, fsdp=1, model=4)
    optimizer = optax.adamw(5e-3)
    step = jpp.make_pp_train_step(jcfg, mesh, optimizer, axis="model", n_micro=2)
    want = []
    with mesh:
        params = jshard_params(jax.tree.map(jnp.copy, world["jparams"]), mesh,
                               jpp.pp_param_specs(jcfg, world["jparams"], axis="model"))
        opt_state = optimizer.init(params)
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, world["batch"])
            want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_pp_rejects_indivisible_layers_and_batch(world):
    layers, batch = result(world, "refuse")
    assert "divide" in layers and "n_layer=3" in layers
    assert "divide" in batch and "n_micro=3" in batch


@pytest.mark.parametrize("fsdp", [1, 2])
def test_pp_specs_match_jax(world, fsdp):
    """pp_param_specs / pp_fsdp_param_specs leaf by leaf against the JAX
    package's PartitionSpecs; pp_in_specs likewise."""
    jcfg, jparams = world["jcfg"], world["jparams"]
    tparams = from_numpy_params(world["params"], "cpu")
    if fsdp == 1:
        want = jpp.pp_param_specs(jcfg, jparams, axis="model")
        got = pp.pp_param_specs(Config(**PP), tparams, axis="model")
    else:
        want = jpp.pp_fsdp_param_specs(jcfg, jparams, axis="model", fsdp_axis="fsdp",
                                       fsdp_size=fsdp)
        got = pp.pp_fsdp_param_specs(Config(**PP), tparams, axis="model", fsdp_axis="fsdp",
                                     fsdp_size=fsdp)
    want = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(w) for w in want] == [tuple(g) + (None,) * (len(w) - len(g))
                                        for w, g in zip(want, got)]
    assert {k: tuple(v) for k, v in jpp.pp_in_specs("model").items()} == pp.pp_in_specs("model")
