"""The port's sharding rules (fastmax_tpu_torch/parallel/sharding.py) against the
JAX package's, without ranks: the per-leaf layout of shard_params against the
reference's param_specs + sanitize_spec for dense, bnb.nf4 and bnb.int8 trees,
the cache specs, the hybrid mesh's rank layout and placement check, and the
fsdp cut's slices. The collectives themselves run on gloo ranks in
tests/test_torch_tp_serving.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.parallel import sharding as jsh
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.parallel import sharding as sh

SMALL = dict(name="shard-test", block_size=64, vocab_size=128, padded_vocab_size=128,
             n_layer=2, n_head=8, n_embd=64, n_query_groups=4, rotary_percentage=1.0,
             parallel_residual=False, bias=False, _norm_class="RMSNorm", _mlp_class="LLaMAMLP",
             intermediate_size=128)
NF4 = {**SMALL, "n_embd": 128, "intermediate_size": 256, "n_query_groups": 8}
TREES = {
    "dense": (SMALL, None),
    "bnb.nf4": (NF4, "bnb.nf4"),
    "bnb.int8": (SMALL, "bnb.int8"),
}
MESHES = [(2, 1), (4, 1), (2, 2), (1, 2), (4, 2)]


def jax_tree(name):
    cfg, mode = TREES[name]
    params = jgpt.init_params(JaxConfig(**cfg), jax.random.PRNGKey(0))
    return cfg, (jquant.quantize_model(params, mode) if mode else params)


def spec_tuple(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


SUB_BLOCKS = {"attn.attn": ("blocks", "attn", "attn"), "attn.proj": ("blocks", "attn", "proj"),
              "mlp.fc_1": ("blocks", "mlp", "fc_1"), "mlp.fc_2": ("blocks", "mlp", "fc_2"),
              "mlp.proj": ("blocks", "mlp", "proj"), "lm_head": ("lm_head",)}


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("tp,fsdp", MESHES)
def test_layout_matches_the_reference_specs(tree, tp, fsdp):
    """Every leaf is cut as the reference's sanitized spec has it, but for two
    stated differences: a sub-block the port keeps whole (its leaves take the
    reference's pure-fsdp layout, and the reference's own sanitize dropped
    ``model`` from one of its leaves: a 4-bit row split off a 64-row block
    cannot run on a rank), and a colwise int8 ``scale8``, which the port
    cuts with its columns where GSPMD slices the replicated leaf at use."""
    cfg_kw, jparams = jax_tree(tree)
    cfg = Config(**cfg_kw)
    params = from_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    mesh = types.SimpleNamespace(shape={"data": 1, "fsdp": fsdp, "model": tp})
    jspecs = jsh.param_specs(JaxConfig(**cfg_kw), jparams, tp=tp > 1, fsdp_size=fsdp)
    jflat = jsh.param_specs(JaxConfig(**cfg_kw), jparams, tp=False, fsdp_size=fsdp)
    mirror = sh.param_specs(cfg, params, tp=tp > 1, fsdp_size=fsdp)
    got = sh.layout_specs(cfg, params, tp=tp, fsdp_size=fsdp)
    kept = sh.split_plan(cfg, params, tp)["kept_whole"]
    kept_paths = [SUB_BLOCKS[k] for k in kept]
    for path, leaf in leaves(params):
        shape = tuple(leaf.shape)
        want = tuple(jsh.sanitize_spec(at(jspecs, path), shape, mesh))
        assert sh.sanitize_spec(at(mirror, path), shape, mesh) == spec_tuple(want, len(shape))
        mine = at(got, path)
        if any(path[:len(k)] == k for k in kept_paths):
            assert mine == spec_tuple(jsh.sanitize_spec(at(jflat, path), shape, mesh),
                                      len(shape)), path
        elif tp > 1 and path[-1] == "scale8" and path[-2] != "proj":
            assert mine[-1] == "model" and want[-1] in (None, "fsdp"), path
        else:
            assert mine == spec_tuple(want, len(shape)), (path, mine, want)
    for k in kept:  # the reference could not cut it either
        p = SUB_BLOCKS[k]
        group = [q for q, _ in leaves(params) if q[:2] == p[:2]]
        assert any(
            "model" in spec_tuple(at(jspecs, q), len(at(params, q).shape)) and "model" not in
            spec_tuple(jsh.sanitize_spec(at(jspecs, q), at(params, q).shape, mesh),
                       len(at(params, q).shape)) for q in group), (k, tp)
    assert kept == ([] if not (tree == "bnb.nf4" and tp == 4) else ["attn.attn", "attn.proj"])


@pytest.mark.parametrize("g", [4, 1])
def test_kv_cache_specs_match(g):
    kw = {**SMALL, "n_query_groups": g}
    for tp in (True, False):
        want = jsh.kv_cache_specs(JaxConfig(**kw), tp=tp)
        got = sh.kv_cache_specs(Config(**kw), tp=tp)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == spec_tuple(want[k], len(got[k])), k
    assert sh.batch_spec() == tuple(jsh.batch_spec())


def test_hybrid_mesh_layout_matches():
    """A simulated 2-granule topology of 8 ranks, granules of 4: the port's rank
    layout is the JAX mesh's device layout, and both placement checks pass."""
    jmesh = jsh.make_hybrid_mesh(data=2, fsdp=2, model=2, granule_size=4)
    jids = np.vectorize(lambda d: d.id)(jmesh.devices)
    layout = sh.hybrid_layout(2, 2, 2, ranks=range(8), granule_size=4)
    np.testing.assert_array_equal(layout, jids)
    sh.assert_hybrid_placement(layout, granule_size=4, all_ranks=range(8))
    assert sh.granule_ids(range(8), granule_size=4) == \
        jsh.granule_ids(jax.devices(), granule_size=4)
    # by node: LOCAL_WORLD_SIZE ranks a node
    assert sh.granule_ids(range(8), local_world_size=2) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_hybrid_mesh_rejects_bad_topology():
    with pytest.raises(ValueError, match="hybrid mesh needs"):
        jsh.make_hybrid_mesh(data=4, fsdp=2, model=1, granule_size=4)
    with pytest.raises(ValueError, match="hybrid mesh needs"):
        sh.hybrid_layout(4, 2, 1, ranks=range(8), granule_size=4)
    flat = jsh.make_mesh(data=2, fsdp=2, model=2)
    with pytest.raises(AssertionError):
        jsh.assert_hybrid_placement(flat, granule_size=2)
    with pytest.raises(AssertionError):
        sh.assert_hybrid_placement(np.arange(8).reshape(2, 2, 2), granule_size=2,
                                   all_ranks=range(8))


def test_local_slices_tile_the_leaf():
    """The blocks of every rank of a (2, 2, 2) mesh tile each leaf exactly once,
    in the reference's axis order (data major within a combined dim)."""
    shape = (2, 8, 4, 16, 8)
    spec = sh.sanitize_spec(sh.kv_cache_specs(Config(**SMALL))["k"], shape,
                            {"data": 2, "fsdp": 2, "model": 2})
    seen = np.zeros(shape, int)
    for d, f, m in np.ndindex(2, 2, 2):
        mesh = types.SimpleNamespace(shape={"data": 2, "fsdp": 2, "model": 2},
                                     coords={"data": d, "fsdp": f, "model": m})
        idx = sh.local_slice(spec, shape, mesh)
        seen[idx] += 1
        assert idx[1] == slice((d * 2 + f) * 2, (d * 2 + f + 1) * 2)
        assert idx[2] == slice(m * 2, (m + 1) * 2)
    assert (seen == 1).all()


@pytest.mark.parametrize("mode", ["preload_int4", "preload_int4_block", "preload_int8",
                                  "quantized"])
@pytest.mark.parametrize("tp", [2, 4])
def test_split_linears_dequantize_to_the_reference_slices(mode, tp):
    """Each rank's cut of a resolved tree (the JAX engine's weights mode on the
    whole tree, gate+up fused) dequantizes to its slice of the JAX package's
    whole dequantized linear, bit for bit: the tiled int4 formats are re-packed
    for the shard from the whole matrix's codes and scales; the fused QKV is cut
    by query group, ``fc_12`` by halves, ``proj`` by rows. At tp 4, 4-bit
    formats cannot cut the 128-row attn.proj on 64-row blocks: attention stays
    whole, as ``split_plan`` says."""
    from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
    from fastmax_tpu.ops import quant as jq
    from fastmax_tpu_torch.ops import quant

    jcfg = JaxConfig(**NF4)
    resolved = JaxEngine.prepare_params(jax_tree("bnb.nf4")[1], mode)
    cfg = Config(**NF4)
    params = from_numpy_params(jax.tree.map(np.asarray, resolved), "cpu")
    split = sh.split_plan(cfg, params, tp)
    assert split["attn"] == (tp == 2 or mode == "preload_int8")
    assert split["mlp"] and split["lm_head"]
    for m in range(tp):
        mesh = types.SimpleNamespace(shape={"data": 1, "fsdp": 1, "model": tp},
                                     coords={"data": 0, "fsdp": 0, "model": m})
        local = sh.split_tree(cfg, params, mesh, split)
        for name, path, role in (("qkv", ("attn", "attn"), "col"),
                                 ("attn.proj", ("attn", "proj"), "row"),
                                 ("fc_12", ("mlp", "fc_12"), "halves"),
                                 ("mlp.proj", ("mlp", "proj"), "row")):
            whole_j = at(resolved["blocks"], path)
            part = at(local["blocks"], path)
            on = split["attn"] if path[0] == "attn" else split["mlp"]
            for layer in range(jcfg.n_layer):
                want = np.asarray(jq.dequantize(
                    {k: (v[layer] if v.ndim > jq._RANK.get(k, 0) else v)
                     for k, v in whole_j.items() if k != "bias"}, jnp.float32))
                got = quant.dequantize({k: (v[layer] if v.dim() > quant._RANK.get(k, 0) else v)
                                        for k, v in part.items() if k != "bias"}).numpy()
                if on:
                    n, k = want.shape[1], want.shape[0]
                    if role == "col":
                        want = want[:, m * n // tp:(m + 1) * n // tp]
                    elif role == "row":
                        want = want[m * k // tp:(m + 1) * k // tp]
                    else:
                        h = n // 2
                        want = np.concatenate([want[:, m * h // tp:(m + 1) * h // tp],
                                               want[:, h + m * h // tp:h + (m + 1) * h // tp]], 1)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} rank {m}")
