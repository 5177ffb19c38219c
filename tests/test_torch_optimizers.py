"""The optimizers of ``--train.optimizer`` in the port (training/quant_optim.py
``AdamW8bit``, training/step.py ``Adafactor`` and ``Lion``, built by
training/fit.build_optimizer after the global-norm clip) against the JAX
package's (its adamw8bit and optax's adafactor and lion) on the CPU.

Leaves: a (300, 200) matrix and a stacked (2, 160, 130) one (factored by
adafactor; blockwise 8-bit in adamw8bit), a (5000,) vector (8-bit, with a
ragged last block), a (64,) vector and a (3, 40) matrix (exact moments).
Tolerances: parameters rtol 1e-5 / atol 1e-7 after five steps
(tests/test_quant_optim.py:58); the 8-bit codes equal the JAX codec's but for
rounding ties, which are counted: a tie is a value whose scaled magnitude
lies within 1e-5 of a half step in either package, so that two float32
divisions may round it to neighbouring codes.

The ``cuda`` test runs the codec on the card against the CPU's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastmax_tpu.training import fit as jfit
from fastmax_tpu.training import quant_optim as jqo
from fastmax_tpu.utils.args import TrainArgs as JaxTrainArgs
from fastmax_tpu_torch.training import fit, quant_optim
from fastmax_tpu_torch.training.step import AdamW, MaskedOptimizer, tree_leaves
from fastmax_tpu_torch.utils.args import TrainArgs

OPTIMIZERS = ("adamw8bit", "adafactor", "lion")
SHAPES = {"w": (300, 200), "stack": (2, 160, 130), "long": (5000,), "vec": (64,),
          "small": (3, 40)}
STEPS = 5
TRAIN = dict(learning_rate=3e-3, lr_warmup_steps=2, max_iters=10, min_lr=3e-4,
             weight_decay=0.1, max_norm=1.0)


def _tree(seed=0):
    """Keys in sorted order at every level: the order of jax.tree.leaves and
    of the port's tree_leaves (insertion order) then agree."""
    rng = np.random.default_rng(seed)
    return {"a": {"stack": (rng.standard_normal(SHAPES["stack"]) * 0.05).astype(np.float32),
                  "w": (rng.standard_normal(SHAPES["w"]) * 0.05).astype(np.float32)},
            "long": (rng.standard_normal(SHAPES["long"]) * 0.05).astype(np.float32),
            "small": (rng.standard_normal(SHAPES["small"]) * 0.05).astype(np.float32),
            "vec": (1.0 + rng.standard_normal(SHAPES["vec"]) * 0.1).astype(np.float32)}


def _grads(step, seed=10):
    """Gradients of mixed scales; a global norm above max_norm on the first
    steps, so that the clip acts there."""
    rng = np.random.default_rng(seed + step)
    scale = 0.02 if step < 2 else 0.002
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale
                                   * (1 + rng.random(a.shape))).astype(np.float32), _tree())


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _run_jax(name, steps=STEPS, mask=None):
    opt = jfit.build_optimizer(JaxTrainArgs(optimizer=name, **TRAIN), mask)
    params = jax.tree.map(jnp.asarray, _tree())
    state = opt.init(params)
    for s in range(steps):
        updates, state = opt.update(jax.tree.map(jnp.asarray, _grads(s)), state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params), state


def _run_port(name, steps=STEPS, mask=None, params=None, opt=None, state=None, start=0):
    opt = opt or fit.build_optimizer(TrainArgs(optimizer=name, **TRAIN), mask)
    params = params if params is not None else _torch(_tree())
    state = state if state is not None else opt.init(params)
    for s in range(start, steps):
        grads = tree_leaves(_torch(_grads(s)))
        if mask is not None:
            grads = [g if m else None for g, m in zip(grads, tree_leaves(mask))]
        opt.update(params, grads, state)
    return params, state, opt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _ties(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Where x / scale lies within 1e-5 (relative) of a half-integer."""
    r = np.abs(x / scale)
    return np.abs(r - np.floor(r) - 0.5) <= 1e-5 * np.maximum(r, 1.0)


# ------------------------------------------------------------------ the 8-bit codec


@pytest.mark.parametrize("n", [4096, 5000, 256 * 40 + 7])
def test_codec_matches_jax(n):
    """quantize_m and quantize_v give the JAX codec's scales bit for bit and
    its codes but at counted rounding ties; a zero block keeps the 1e-12
    floor; the decoders agree to float32 rounding."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n))).astype(np.float32)
    x[:256] = 0.0
    v = x * x
    for q, dq, jq, jdq, arg in ((quant_optim.quantize_m, quant_optim.dequantize_m,
                                 jqo.quantize_m, jqo.dequantize_m, x),
                                (quant_optim.quantize_v, quant_optim.dequantize_v,
                                 jqo.quantize_v, jqo.dequantize_v, v)):
        got = q(torch.from_numpy(arg))
        want = jax.tree.map(np.asarray, jq(jnp.asarray(arg)))
        np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
        assert got["q"].dtype == {np.dtype("int8"): torch.int8,
                                  np.dtype("uint8"): torch.uint8}[want["q"].dtype]
        differ = got["q"].numpy() != want["q"]
        src = np.concatenate([arg, np.zeros((-n) % 256, np.float32)]).reshape(-1, 256)
        src = np.sqrt(src) if q is quant_optim.quantize_v else src
        assert not (differ & ~_ties(src, want["scale"])).any()
        assert differ.sum() <= 2, differ.sum()
        assert float(want["scale"][0, 0]) * (127.0 if q is quant_optim.quantize_m else 255.0) \
            == np.float32(1e-12)
        back = dq(got, (n,)).numpy()
        np.testing.assert_allclose(back, np.asarray(jdq(jax.tree.map(jnp.asarray, want), n,
                                                        (n,))), rtol=1e-6, atol=0)


def test_small_leaves_equal_adamw():
    """With every leaf below MIN_QUANT_SIZE and a constant learning rate,
    adamw8bit's exact moments make it the port's adamw (rtol 1e-5 / atol
    1e-7) after five steps."""
    tree = {k: v for k, v in _tree().items() if k in ("vec", "small")}
    sched = (lambda c: 1e-3)
    a, b = _torch(tree), _torch(tree)
    opt8 = quant_optim.AdamW8bit(sched, 0.9, 0.95, weight_decay=0.1, max_norm=1.0)
    opt = AdamW(sched, 0.9, 0.95, weight_decay=0.1, max_norm=1.0)
    s8, s = opt8.init(a), opt.init(b)
    assert all(isinstance(m, torch.Tensor) and m.dtype == torch.float32 for m in s8["m"])
    for step in range(STEPS):
        g = {k: v for k, v in _grads(step).items() if k in tree}
        opt8.update(a, tree_leaves(_torch(g)), s8)
        opt.update(b, tree_leaves(_torch(g)), s)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ against optax


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_five_steps_match_jax(name):
    """Five steps of the clipped optimizer on the warmup-cosine schedule
    against the JAX package's build_optimizer; adamw8bit's 8-bit moments
    against its codes, ties counted."""
    want, jstate = _run_jax(name)
    got, state, _ = _run_port(name)
    eight_bit = ("a.stack", "a.w", "long") if name == "adamw8bit" else ()
    flips = 0
    for n, w in _flat(want).items():
        g = _flat(got)[n]
        if n in eight_bit:
            # a moment code one step off at a tie moves its parameter by at most a step's
            # share of the update: held at 1e-3 relative, and counted
            bad = ~np.isclose(g, w, rtol=1e-5, atol=1e-7)
            flips += int(bad.sum())
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=n)
    n_big = sum(int(np.prod(SHAPES[k])) for k in ("w", "stack", "long"))
    assert flips <= 1e-4 * n_big, (flips, n_big)
    if name == "adamw8bit":
        inner = jstate[1]
        assert int(inner.count) == state["count"] == STEPS
        ties = 0
        for i, (jm, jv) in enumerate(zip(inner.m, inner.v)):
            m, v = state["m"][i], state["v"][i]
            if isinstance(jm, dict):
                for ours, theirs in ((m, jm), (v, jv)):
                    np.testing.assert_allclose(ours["scale"].numpy(), np.asarray(theirs["scale"]),
                                               rtol=1e-5, atol=0)
                    step = np.abs(ours["q"].numpy().astype(np.int32)
                                  - np.asarray(theirs["q"]).astype(np.int32))
                    assert step.max() <= 1
                    ties += int(step.sum())
            else:
                np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-9)
        n_codes = 2 * sum(int(np.prod(SHAPES[k])) for k in ("w", "stack", "long"))
        assert ties <= 1e-4 * n_codes, (ties, n_codes)
    if name == "adafactor":
        # optax's dims: (second largest, largest) axis; v_row drops the largest
        assert state["v"][1] is None and tuple(state["v_row"][1].shape) == (200,)
        assert tuple(state["v_row"][0].shape) == (2, 130)
        assert tuple(state["v_col"][0].shape) == (2, 160)
        assert state["v_row"][4] is None and tuple(state["v"][4].shape) == (64,)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_masked_composition_matches_jax(name):
    """Under a trainable mask the frozen leaves keep their values and have no
    state, and the clip takes the trainable leaves' norm alone, as the JAX
    package's masked_optimizer does."""
    mask = {"a": {"stack": False, "w": True}, "long": True, "small": True, "vec": False}
    want, _ = _run_jax(name, mask=mask)
    tmask = jax.tree.map(bool, mask)
    got, state, opt = _run_port(name, mask=tmask)
    assert isinstance(opt, MaskedOptimizer)
    init = _flat(_tree())
    for n, w in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[n], w, rtol=1e-5, atol=1e-7, err_msg=n)
        if not _flat(mask)[n]:
            np.testing.assert_array_equal(_flat(got)[n], init[n], err_msg=n)
    per_leaf = state["mu"] if name == "lion" else state["v"] if name == "adafactor" \
        else state["m"]
    assert len(per_leaf) == 3


@pytest.mark.parametrize("name", OPTIMIZERS + ("adamw",))
def test_save_and_resume_equal_an_unbroken_run(tmp_path, name):
    """Three steps, the train state saved by fit.save_train_state (the 8-bit
    codes, adafactor's factored statistics, lion's momentum) and loaded back,
    then two more: equal to five unbroken steps bit for bit."""
    full, _, _ = _run_port(name)
    params, state, opt = _run_port(name, steps=3)
    fit.save_train_state(fit.TrainState(params, state, 3), tmp_path)
    back = fit.load_train_state(tmp_path, "cpu")
    assert back.step == 3
    if name == "adamw8bit":
        assert back.opt_state["m"][0]["q"].dtype == torch.int8
        assert back.opt_state["v"][0]["q"].dtype == torch.uint8
    resumed, _, _ = _run_port(name, params=back.params, opt=opt, state=back.opt_state, start=3)
    for a, b in zip(tree_leaves(resumed), tree_leaves(full)):
        assert torch.equal(a, b)


def test_state_bytes_and_integer_leaves():
    """adamw8bit keeps 2 + 8/256 bytes a parameter of its 8-bit leaves, as
    the JAX state_nbytes counts them; an integer leaf has no state and is
    left as it is."""
    tree = _torch(_tree())
    tree["codes"] = torch.arange(12, dtype=torch.uint8)
    opt = quant_optim.AdamW8bit(lambda c: 1e-3)
    state = opt.init(tree)
    assert state["m"][-1] is None and state["v"][-1] is None
    jstate = jqo.adamw8bit(1e-3).init(jax.tree.map(jnp.asarray, {
        **_tree(), "codes": np.arange(12, dtype=np.uint8)}))
    assert quant_optim.state_nbytes(state) == jqo.state_nbytes(jstate) - 4  # JAX's count is int32
    adam = quant_optim.state_nbytes(AdamW(lambda c: 1e-3).init(
        {k: v for k, v in tree.items() if k != "codes"}))
    assert quant_optim.state_nbytes(state) < 0.3 * adam
    blocks = -(-int(np.prod(SHAPES["w"])) // quant_optim.BLOCK)  # the last one padded
    assert quant_optim.state_nbytes([state["m"][1], state["v"][1]]) == \
        2 * blocks * (quant_optim.BLOCK + 4)
    grads = [torch.ones_like(p) if p.is_floating_point() else None for p in tree_leaves(tree)]
    opt.update(tree, grads, state)
    assert torch.equal(tree["codes"], torch.arange(12, dtype=torch.uint8))


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="sgd"):
        fit.build_optimizer(TrainArgs(optimizer="sgd"))


# ------------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_codec_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(1 << 20) * 1e-3).astype(np.float32))
    for q in (quant_optim.quantize_m, quant_optim.quantize_v):
        arg = x if q is quant_optim.quantize_m else x * x
        cpu, card = q(arg), q(arg.cuda())
        # the card's float32 division and square root may round an ulp off the CPU's
        torch.testing.assert_close(card["scale"].cpu(), cpu["scale"], rtol=2.0 ** -22, atol=0)
        assert int((card["q"].cpu() != cpu["q"]).sum()) <= 16
