"""The port's pretraining path (fastmax_tpu_torch/training, the no-cache
forward of models/gpt.py) against the JAX package on the CPU, on the same
weights (the JAX package's init, brought over by from_numpy_params) and the
same numpy token batches.

A 2-layer, 128-wide model shaped like easy-transformer-fastmax (2 heads of
64, block 256, LayerNorm, GPT-NeoX MLP with bias, parallel residual, 25 %
RoPE, scaled embeddings). The JAX package's fastmax takes its Pallas route
(interpret mode), as it does on its chip. Tolerances, float32 throughout:
logits atol 1e-4 (the repo's model tolerance); the loss 1e-5 relative; each
gradient leaf 1e-3 of its largest entry (two chunked scans and a
recomputed backward, summed in different orders); the optimizer against
optax 1e-6 relative (the same arithmetic in another order); after three
fit steps each parameter leaf within 1e-4 of the JAX package's (Adam
divides each gradient by its own running magnitude, which lifts the
gradients' rounding differences to about that size after a step of lr 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import fastmax as jfm
from fastmax_tpu.training import fit as jfit
from fastmax_tpu.training import step as jstep
from fastmax_tpu.training.step import make_loss_fn as jax_loss_fn
from fastmax_tpu.utils.args import TrainArgs as JaxTrainArgs
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config, registry
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.ops.attention import attention
from fastmax_tpu_torch.training import fit, pretrain
from fastmax_tpu_torch.training.step import (default_optimizer, make_loss_fn, make_train_step,
                                             tree_leaves, warmup_cosine_decay_schedule)
from fastmax_tpu_torch.utils.args import EvalArgs, IOArgs, TrainArgs

torch.set_num_threads(2)
SMALL = dict(n_layer=2, n_embd=128, n_head=2, block_size=256)


@pytest.fixture
def pallas_route(monkeypatch):
    monkeypatch.setattr(jfm, "FASTMAX_IMPL", "pallas")


def _params(attn_alg, gelu="none"):
    kw = dict(SMALL, attn_alg=attn_alg, gelu_approximate=gelu)
    jcfg = JaxConfig.from_name("easy-transformer-fastmax", **kw)
    cfg = Config.from_name("easy-transformer-fastmax", **kw)
    jp = jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    return jcfg, cfg, jp


def _batch(seed, b=2, t=256):
    return np.random.default_rng(seed).integers(0, 205, (b, t + 1)).astype(np.int64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("attn_alg,gelu", [("fastmax_cuda", "none"), ("quadratic", "none"),
                                           ("quadratic", "tanh")])
def test_loss_and_gradients_match_jax(attn_alg, gelu, pallas_route):
    jcfg, cfg, jp = _params(attn_alg, gelu)
    batch = _batch(1)
    jlogits, _ = jgpt.forward(jp, jcfg, jnp.asarray(batch[:, :-1]))
    jloss, jgrads = jax.value_and_grad(jax_loss_fn(jcfg, remat=True))(jp, jnp.asarray(batch))

    tp = from_numpy_params(jp, "cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tb = torch.from_numpy(batch)
    with torch.no_grad():
        logits, cache = gpt.forward(tp, cfg, tb[:, :-1])
    assert cache is None and logits.shape == (2, 256, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    loss = make_loss_fn(cfg, remat=True)(tp, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(_grads(tp))
    assert set(got) == set(want)
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= 1e-3 * max(np.abs(ref).max(), 1e-12), (name, err)


def test_init_params_has_the_jax_layout():
    """The port's GPT-NeoX init gives the JAX package's keys, shapes and
    dtypes: std 0.02 weights, zero biases, unit norm weights."""
    jcfg, cfg, jp = _params("fastmax_cuda")
    got = _flat(to_numpy_params(gpt.init_params(cfg, seed=3, device="cpu")))
    want = _flat(jp)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    assert abs(got["blocks.mlp.fc.kernel"].std() - 0.02) < 1e-3
    assert not got["blocks.attn.attn.bias"].any() and (got["ln_f.weight"] == 1).all()


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad.numpy() for k, v in tree.items()}


def test_remat_gives_the_same_gradients():
    _, cfg, jp = _params("fastmax_cuda")
    tb = torch.from_numpy(_batch(2, t=128))
    grads = []
    for remat in (False, True):
        tp = from_numpy_params(jp, "cpu")
        for p in tree_leaves(tp):
            p.requires_grad_(True)
        make_loss_fn(cfg, remat=remat)(tp, tb).backward()
        grads.append([p.grad for p in tree_leaves(tp)])
    for a, b in zip(*grads):  # the same arithmetic; threads may sum in another order
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)
    for policy in ("attn", "dots", "dots_attn"):
        with pytest.raises(NotImplementedError, match="XLA"):
            gpt.forward(from_numpy_params(jp, "cpu"), cfg, tb[:, :-1], remat=policy)


def test_quadratic_without_mask_stops_at_blockwise_length(monkeypatch):
    """At T >= BLOCKWISE_MIN_T the quadratic route leaves the dense softmax for
    the trainable flash route (the fused entry; its plain version on the
    CPU), which gives the dense softmax's output (f32, atol 2e-5 / rtol
    1e-4, the reference's flash tolerance)."""
    from fastmax_tpu_torch.ops import attention as tattn
    from fastmax_tpu_torch.ops.attention import scaled_dot_product_attention

    fused, calls = tattn.flash_attention_fused, []
    monkeypatch.setattr(tattn, "flash_attention_fused",
                        lambda *a, **k: calls.append(a[0].shape) or fused(*a, **k))
    x = torch.randn((1, 2, 1024, 64), generator=torch.Generator().manual_seed(0))
    out = attention(x, x, x, attn_alg="quadratic", head_size=64)
    assert calls == [(1, 2, 1024, 64)]
    torch.testing.assert_close(out, scaled_dot_product_attention(x, x, x, is_causal=True),
                               atol=2e-5, rtol=1e-4)
    attention(x[:, :, :1023], x[:, :, :1023], x[:, :, :1023], attn_alg="quadratic", head_size=64)
    assert len(calls) == 1


class _Losses:
    def __init__(self):
        self.rows = {}

    def log_dict(self, metrics, step):
        self.rows[step] = metrics


def test_fit_matches_jax_fit(pallas_route):
    """Three optimizer steps of two micro-batches each (warmup 1: the first
    update has lr 0, the second the peak, the third is cosine)."""
    jcfg, cfg, jp = _params("fastmax_cuda")
    batches = [_batch(10 + i) for i in range(6)]
    kw = dict(global_batch_size=4, micro_batch_size=2, max_iters=3, lr_warmup_steps=1,
              learning_rate=1e-3, log_interval=1, save_interval=1000)

    jtrain = JaxTrainArgs(**kw)
    opt = jfit.build_optimizer(jtrain)
    jlog = _Losses()
    jstate = jfit.fit(jcfg, jfit.TrainState(jp, opt.init(jp)), opt, iter(batches),
                      train=jtrain, logger=jlog, remat=True)

    train = TrainArgs(**kw)
    topt = fit.build_optimizer(train)
    tp = from_numpy_params(jp, "cpu")
    tlog = _Losses()
    tstate = fit.fit(cfg, fit.TrainState(tp, topt.init(tp)), topt, iter(batches), train=train,
                     logger=tlog, remat=True)

    assert tstate.step == jstate.step == 3
    for s in (1, 2, 3):
        np.testing.assert_allclose(tlog.rows[s]["loss"], jlog.rows[s]["loss"], rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_numpy_params(tstate.params))
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, atol=1e-4, err_msg=name)


def test_optimizer_matches_optax():
    """build_optimizer against optax's chain on fixed gradients: the lr-0 first
    step, clipped steps (global norm above 1) and cosine steps."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [{"a": (rng.standard_normal((4, 3)) * s).astype(np.float32),
              "b": {"c": (rng.standard_normal(5) * s).astype(np.float32)}}
             for s in (0.1, 3.0, 0.05, 2.0, 0.2, 0.01)]
    kw = dict(learning_rate=1e-2, lr_warmup_steps=2, max_iters=5, weight_decay=0.1,
              max_norm=1.0, min_lr=1e-3)
    jopt = jfit.build_optimizer(JaxTrainArgs(**kw))
    jstate = jopt.init(params)
    jp = params
    topt = fit.build_optimizer(TrainArgs(**kw))
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    tstate = topt.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(g["a"]), torch.from_numpy(g["b"]["c"])], tstate)
        for got, ref in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")
        if i == 0:
            for got, start in zip(tree_leaves(tp), jax.tree.leaves(params)):
                np.testing.assert_array_equal(got.numpy(), start)  # lr 0: no step, no decay
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-3)
    mine = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-3)
    for count in range(8):
        assert abs(mine(count) - float(sched(count))) <= 1e-9


def test_train_step_matches_jax():
    """make_train_step with default_optimizer (warmup 1: lr 0, then the peak)
    against the JAX package's, two steps, quadratic attention."""
    jcfg, cfg, jp = _params("quadratic")
    batches = [_batch(20 + i, t=128) for i in range(2)]
    jfn = jstep.make_train_step(jcfg, jstep.default_optimizer(warmup_steps=1, total_steps=10),
                                donate=False)
    opt = default_optimizer(warmup_steps=1, total_steps=10)
    tfn = make_train_step(cfg, opt)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jstep.default_optimizer(warmup_steps=1, total_steps=10).init(jparams)
    tp = from_numpy_params(jp, "cpu")
    tstate = opt.init(tp)
    for b in batches:
        jparams, jstate, jloss = jfn(jparams, jstate, jnp.asarray(b))
        tp, tstate, loss = tfn(tp, tstate, torch.from_numpy(b))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, jparams))
    got = _flat(to_numpy_params(tp))
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, atol=1e-4, err_msg=name)


@pytest.fixture
def tiny_entry():
    registry()["test-tiny-fastmax"] = dict(
        name="test-tiny-fastmax", scale_embeddings=True, block_size=128, vocab_size=64,
        padded_vocab_size=64, n_layer=2, n_head=2, n_embd=64, attn_alg="fastmax_cuda")
    yield "test-tiny-fastmax"
    registry().pop("test-tiny-fastmax")


def test_pretrain_setup_trains_and_resumes(tmp_path, tiny_entry):
    data = tmp_path / "data"
    data.mkdir()
    (np.arange(60_000) % 7 + 3).astype(np.uint16).tofile(data / "train.bin")
    (data / "meta.json").write_text('{"dtype": "uint16"}')
    out = tmp_path / "out"
    common = dict(model_name=tiny_entry, data_format="openwebtext", device="cpu",
                  eval=EvalArgs(interval=1000, max_iters=1))
    state = pretrain.setup(
        train=TrainArgs(global_batch_size=4, micro_batch_size=2, max_iters=12,
                        learning_rate=3e-3, lr_warmup_steps=2, log_interval=1,
                        save_interval=6),
        io=IOArgs(train_data_dir=data, out_dir=out), **common)
    assert state.step == 12
    rows = (out / "metrics.csv").read_text().strip().splitlines()
    header = rows[0].split(",")
    losses = [float(dict(zip(header, r.split(",")))["loss"]) for r in rows[1:]]
    assert losses[-1] < 0.8 * losses[0], losses
    assert (out / "state" / "train_state.pt").is_file()
    state = pretrain.setup(
        train=TrainArgs(global_batch_size=4, micro_batch_size=2, max_iters=15,
                        learning_rate=3e-3, lr_warmup_steps=2, log_interval=1,
                        save_interval=6),
        io=IOArgs(train_data_dir=data, out_dir=out, resume=True), **common)
    assert state.step == 15
    assert state.opt_state["count"] == 15


def test_where_the_training_slice_stops(tmp_path):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        pretrain.setup(dp=2, device="cpu")
    with pytest.raises(NotImplementedError, match="packed"):
        pretrain.data_iterators("packed", IOArgs(train_data_dir=tmp_path), 16, 2)
    with pytest.raises(NotImplementedError, match="lion"):
        fit.build_optimizer(TrainArgs(optimizer="lion"))
