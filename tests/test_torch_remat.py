"""The port's remat policies (models/gpt._remat_wrap, _layer_policies) and the
``FASTMAX_TPU_TRAIN_ATTN=auto`` probe (ops/attention._probe_train_kernel)
against the JAX package on the CPU.

The model is the 2-layer 128-wide GQA LLaMA of tests/test_quant_pallas.py:120-123
with n_head=4 and n_query_groups=2 (head size 32), at T = 32 with the trainable
blockwise route forced on at toy sizes (BLOCKWISE_MIN_T = BLOCKWISE_BLOCK = 16),
as tests/test_training.py:242 forces it, so the attention forward's (out, lse)
exist for "attn" to keep. Tolerances, float32: every policy's loss and each
gradient leaf against the port's remat=False at rtol 1e-5, atol 1e-6 (the
reference's own, tests/test_training.py:211-239); against the JAX package's
same policy the loss at rtol 1e-5 and each leaf within 1e-5 of its largest
entry (two libraries' sums in other orders).
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import attention as jattn
from fastmax_tpu.ops.linear import linear as jax_linear
from fastmax_tpu.utils.loss import cross_entropy as jax_cross_entropy
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.ops import attention as tattn
from fastmax_tpu_torch.ops import blockwise_attention as tba
from fastmax_tpu_torch.ops import flash_attention as tfa
from fastmax_tpu_torch.ops.linear import linear
from fastmax_tpu_torch.training.step import tree_leaves
from fastmax_tpu_torch.utils.loss import cross_entropy

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False)
T = 32
POLICIES = ("full", "attn", "dots", "dots_attn", "dots@1:full", "attn@1:dots")


@pytest.fixture
def blockwise_route(monkeypatch):
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "BLOCKWISE_MIN_T", 16)
        monkeypatch.setattr(mod, "BLOCKWISE_BLOCK", 16)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", "blockwise")


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**TINY)
    jp = jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    batch = np.random.default_rng(0).integers(0, 128, (2, T + 1)).astype(np.int32)
    return jcfg, Config(**TINY), jp, batch


def torch_loss_grads(cfg, jp, batch, remat):
    tp = from_numpy_params(jp, "cpu")
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = torch.from_numpy(batch).long()
    hidden = gpt.forward_hidden(tp, cfg, tb[:, :-1], remat=remat)
    loss = cross_entropy(linear(tp["lm_head"], hidden), tb[:, 1:])
    loss.backward()
    return float(loss.detach()), [p.grad for p in leaves]


def jax_loss_grads(jcfg, jp, batch, remat):
    # forward_hidden: the reference takes the mixed form there (its forward does not)
    def loss(params):
        hidden = jgpt.forward_hidden(params, jcfg, jnp.asarray(batch[:, :-1]), remat=remat)
        return jax_cross_entropy(jax_linear(params["lm_head"], hidden),
                                 jnp.asarray(batch[:, 1:]))

    value, grads = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, jp))
    return float(value), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gives_the_no_remat_gradients_and_the_jax_policy(policy, model, blockwise_route):
    jcfg, cfg, jp, batch = model
    loss0, grads0 = torch_loss_grads(cfg, jp, batch, False)
    loss, grads = torch_loss_grads(cfg, jp, batch, policy)
    np.testing.assert_allclose(loss, loss0, rtol=1e-5)
    for a, b in zip(grads, grads0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    jloss, jgrads = jax_loss_grads(jcfg, jp, batch, policy)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    # the JAX tree's leaves come in sorted key order, the port's in insertion order
    want = dict(zip(sorted(_paths(from_numpy_params(jp, "cpu"))), jgrads))
    for name, g in zip(_paths(from_numpy_params(jp, "cpu")), grads):
        ref = want[name]
        assert np.max(np.abs(g.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref)), name


def _paths(tree, prefix=()):
    out = []
    for k, v in tree.items():
        out += _paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)]
    return out


def test_malformed_policies_raise_like_jax(model, blockwise_route):
    jcfg, cfg, jp, batch = model
    for bad in ("bogus", "bogus@1:full", "dots@x:full"):
        with pytest.raises(ValueError):
            jax_loss_grads(jcfg, jp, batch, bad)
        with pytest.raises(ValueError, match="remat" if bad == "bogus" else None):
            torch_loss_grads(cfg, jp, batch, bad)
    with pytest.raises(ValueError, match="remat"):  # the reference raises here too (unpacking)
        torch_loss_grads(cfg, jp, batch, "dots@8")
    assert gpt._layer_policies("dots@1:full", 3) == ["dots", "full", "full"]
    assert gpt._layer_policies("attn@8:dots", 2) == ["attn", "attn"]
    assert gpt._layer_policies(True, 2) == [True, True]


class LiveTensors(TorchDispatchMode):
    """Every tensor an operator makes while the mode is on, held weakly."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append(weakref.ref(t))
        return out

    def bytes_alive(self) -> int:
        """Bytes of the distinct storages of the made tensors still alive."""
        seen = {}
        for ref in self.made:
            t = ref()
            if t is not None:
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())


def saved_after_forward(cfg, jp, batch, remat, calls):
    """(bytes the forward leaves alive for the backward, attention forwards
    run in the forward, in the backward)."""
    tp = from_numpy_params(jp, "cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tb = torch.from_numpy(batch).long()
    calls.clear()
    with LiveTensors() as mode:
        hidden = gpt.forward_hidden(tp, cfg, tb[:, :-1], remat=remat)
    n_fwd = len(calls)
    kept = mode.bytes_alive() - hidden.untyped_storage().nbytes()
    hidden.float().square().sum().backward()
    return kept, n_fwd, len(calls) - n_fwd


def test_saved_bytes_and_recomputed_attention(model, blockwise_route, monkeypatch):
    """"attn" keeps each layer's (out, lse) and nothing else beyond "full":
    not q, k or v; its backward re-runs no attention forward, where "full"
    and "dots" re-run one a layer. "full" keeps the least, no remat the
    most."""
    jcfg, cfg, jp, batch = model
    calls = []
    forward = tba._forward
    monkeypatch.setattr(tba, "_forward", lambda *a: calls.append(1) or forward(*a))
    got = {str(r): saved_after_forward(cfg, jp, batch, r, calls)
           for r in (False, "full", "attn", "dots", "dots_attn")}
    b, h, d = batch.shape[0], cfg.n_head, cfg.head_size
    out_lse = cfg.n_layer * (b * h * T * d + b * h * T) * 4
    assert got["attn"][0] - got["full"][0] == out_lse, got
    assert got["dots_attn"][0] - got["dots"][0] == out_lse, got
    assert min(v[0] for v in got.values()) == got["full"][0] > 0
    assert max(v[0] for v in got.values()) == got["False"][0]
    for r, (_, fwd, bwd) in got.items():
        assert fwd == cfg.n_layer, (r, fwd)
        assert bwd == (cfg.n_layer if r in ("full", "dots") else 0), (r, bwd)


# ------------------------------------------------------------------ the probe


@pytest.fixture
def probe(monkeypatch, tmp_path):
    """A fresh probe: empty in-process cache, the disk record under tmp_path,
    a timer that runs nothing and answers from ``times`` in call order."""
    monkeypatch.setattr(tattn, "_PROBE_CACHE", {})
    monkeypatch.setattr(tattn, "PROBE_TIMES", {})
    path = tmp_path / "_build" / "kernel_probe.json"
    monkeypatch.setattr(tattn, "_probe_path", lambda: path)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", "auto")
    state = {"times": [], "calls": 0}

    def timer(fn, q, k, v):
        state["calls"] += 1
        return state["times"].pop(0)

    monkeypatch.setattr(tattn, "_time_fwd_bwd", timer)
    state["path"] = path
    return state


@pytest.mark.parametrize("t_block,t_flash,winner", [(2.0, 1.0, "flash2"), (1.0, 2.0, "blockwise")])
def test_probe_winner_follows_the_timer(probe, t_block, t_flash, winner):
    import json

    probe["times"] = [t_block, t_flash]  # the probe times blockwise first, then flash2
    assert tattn._probe_train_kernel(1, 2, 2048, 64, "cpu") == winner
    key = "cpu|1x2x2048x64"
    assert tattn.PROBE_TIMES[key] == {"blockwise": t_block, "flash2": t_flash}
    assert json.loads(probe["path"].read_text()) == {key: winner}
    # cached: in the process, then (a fresh process) on disk, neither timed again
    assert tattn._probe_train_kernel(1, 2, 2048, 64, "cpu") == winner
    tattn._PROBE_CACHE.clear()
    assert tattn._probe_train_kernel(1, 2, 2048, 64, "cpu") == winner
    assert probe["calls"] == 2
    # _train_kernel under auto: probed at D % 64 == 0 and T >= FLASH_MIN_T only
    assert tattn._train_kernel(2048, 64, 1, 2, "cpu") == winner
    assert tattn._train_kernel(2048, 96, 1, 2, "cpu") == "blockwise"
    assert tattn._train_kernel(tattn.FLASH_MIN_T - 128, 64, 1, 2, "cpu") == "blockwise"
    assert probe["calls"] == 2


def test_probe_publishes_atomically_and_skips_ineligible_shapes(probe, monkeypatch):
    import json
    import os

    renames = []
    replace = os.replace
    monkeypatch.setattr(tattn.os, "replace", lambda a, b: renames.append((a, b)) or replace(a, b))
    probe["path"].parent.mkdir(parents=True)
    probe["path"].write_text(json.dumps({"other|1x1x1x64": "flash2"}))
    # outside _fused_eligible (T*D > 4096*64): blockwise, nothing timed or written
    assert tattn._probe_train_kernel(1, 2, 4096, 128, "cpu") == "blockwise"
    assert probe["calls"] == 0 and not renames
    probe["times"] = [1.0, 2.0]
    assert tattn._probe_train_kernel(2, 4, 2048, 128, "cpu") == "blockwise"
    (tmp, dst), = renames
    assert dst == probe["path"] and tmp.parent == dst.parent and tmp.name != dst.name
    assert str(os.getpid()) in tmp.name and not tmp.exists()
    assert json.loads(dst.read_text()) == {"other|1x1x1x64": "flash2",
                                           "cpu|2x4x2048x128": "blockwise"}


def test_probe_runs_inside_a_checkpointed_block(monkeypatch, tmp_path):
    """The real probe (plain versions on the CPU) at T = 128 with FLASH_MIN_T
    lowered, first reached inside an "attn" block's checkpoint: it times
    both routes on its own thread, the winner is the faster by its own
    timings, and the step's gradients equal remat=False's under the same
    route."""
    kw = {**TINY, "n_head": 2, "n_query_groups": 2, "block_size": 128}  # D = 64
    cfg = Config(**kw)
    jp = jax.tree.map(np.asarray, jgpt.init_params(JaxConfig(**kw), jax.random.PRNGKey(1),
                                                   jnp.float32))
    assert tfa._fused_eligible(128, 64)
    batch = np.random.default_rng(1).integers(0, 128, (1, 129)).astype(np.int32)
    monkeypatch.setattr(tattn, "_PROBE_CACHE", {})
    monkeypatch.setattr(tattn, "PROBE_TIMES", {})
    monkeypatch.setattr(tattn, "_probe_path", lambda: tmp_path / "kernel_probe.json")
    monkeypatch.setattr(tattn, "BLOCKWISE_MIN_T", 64)
    monkeypatch.setattr(tattn, "BLOCKWISE_BLOCK", 64)
    monkeypatch.setattr(tattn, "FLASH_MIN_T", 128)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", "auto")
    loss, grads = torch_loss_grads(cfg, jp, batch, "attn")
    (key, times), = tattn.PROBE_TIMES.items()
    assert key == "cpu|1x2x128x64" and set(times) == {"blockwise", "flash2"}
    winner = tattn._PROBE_CACHE[key]
    assert winner == min(times, key=times.get)
    monkeypatch.setattr(tattn, "TRAIN_ATTN", winner)
    loss0, grads0 = torch_loss_grads(cfg, jp, batch, False)
    np.testing.assert_allclose(loss, loss0, rtol=1e-5)
    for a, b in zip(grads, grads0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
