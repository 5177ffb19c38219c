"""The linear arms' decode state in the port against the JAX package on the
CPU, float32: the state functions of ``ops/fastmax.py`` and the reference's
own tests of ``tests/test_linear_decode.py`` rerun on the port.
``gpt.forward_linear_cache`` and the cached forward over a dense cache are
held in ``tests/test_torch_linear_cache.py``; the engine, the batcher and the
command lines with a linear arm in ``tests/test_torch_linear_serving.py``.

States are compared on the entries each arm reads: at p = 1 the JAX scan
returns ``s_kkv`` (B, H, 1, 1) and ``s_kk`` (B, H, 1) where the port keeps
the (B, H, 1, D) and (B, H, 1) placeholders of the empty state; no p = 1
step reads them, and performer reads only ``s_kv`` and ``s_k``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.ops import fastmax as jfm
from fastmax_tpu_torch.inference.engine import InferenceEngine
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_state
from fastmax_tpu_torch.ops import fastmax as tfm

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)

STATE_REL = 1e-5     # states and op outputs: of the largest entry of the reference
READS = {"fastmax": tfm.STATE_NAMES, "fastmax_cuda": tfm.STATE_NAMES,
         "linearmax": tfm.STATE_NAMES[:4] + ("q_div", "k_div"), "performer": ("s_kv", "s_k")}


def held(what, got, ref, rel=STATE_REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got.reshape(ref.shape) - ref).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest ({scale:.3e}) > {rel}"


def held_state(alg, got, ref):
    for name in READS[alg]:
        held(name, got[name], ref[name])


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _fastmax_ops(p):
    def step(mod):
        return lambda s, q, k, v: mod.linear_attn_decode_step(s, q, k, v,
                                                              8.0 * q.shape[-1] ** 0.5, p)

    return (lambda q, k, v: jfm.fastmax_prefill_state(q, k, v, p=p),
            lambda q, k, v: tfm.fastmax_prefill_state(q, k, v, p=p),
            step(jfm), step(tfm), tfm.STATE_NAMES[:6 if p == 2 else 4])


OPS = {  # arm: (JAX prefill, port prefill, JAX step, port step, entries read)
    "fastmax2": _fastmax_ops(2),
    "fastmax1": _fastmax_ops(1),
    "linearmax": (jfm.linearmax_prefill_state, tfm.linearmax_prefill_state,
                  jfm.linearmax_decode_step, tfm.linearmax_decode_step, READS["linearmax"]),
    "performer": (jfm.performer_prefill_state, tfm.performer_prefill_state,
                  jfm.performer_decode_step, tfm.performer_decode_step, READS["performer"]),
}


@pytest.mark.parametrize("n", [17, 133])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_state_functions_match_jax(d, n):
    """Each arm's prefill (output and state) and three decode steps that
    continue the JAX prefill's state in the port (in place)."""
    q, k, v = _qkv(d + n, (1, 2, n + 3, d))
    for arm, (jpre, tpre, jstep, tstep, reads) in OPS.items():
        jo, js = jpre(*(jnp.asarray(a[:, :, :n]) for a in (q, k, v)))
        to, ts = tpre(*(torch.from_numpy(a[:, :, :n]) for a in (q, k, v)))
        held(f"{arm} prefill output", to, jo)
        for name in reads:
            held(f"{arm} prefill {name}", ts[name], js[name])
        ts = from_numpy_state({name: np.asarray(x) for name, x in js.items()}, "cpu")
        tensors = dict(ts)
        for t in range(n, n + 3):
            js, jo = jstep(js, *(jnp.asarray(a[:, :, t]) for a in (q, k, v)))
            same, to = tstep(ts, *(torch.from_numpy(a[:, :, t]) for a in (q, k, v)))
            assert same is ts and all(ts[name] is x for name, x in tensors.items())
            held(f"{arm} step {t} output", to, jo)
        for name in reads:
            held(f"{arm} state {name} after the steps", ts[name], js[name])


def test_state_init_shapes():
    want = jfm.linear_attn_state_init(2, 3, 8, 2)
    got = tfm.linear_attn_state_init(2, 3, 8, 2)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(not bool(v.any()) and v.dtype == torch.float32 for v in got.values())
    assert tuple(tfm.linear_attn_state_init(2, 3, 8, 1)["s_kkv"].shape) == (2, 3, 1, 8)


# ------------------------------------------------ tests/test_linear_decode.py on the port


def ref_cfg(alg):
    return Config(name=f"lin-{alg}", block_size=96, vocab_size=96, padded_vocab_size=96,
                  n_layer=2, n_head=4, n_embd=64, n_query_groups=2, rotary_percentage=1.0,
                  parallel_residual=False, bias=False, _norm_class="RMSNorm",
                  _mlp_class="LLaMAMLP", intermediate_size=128, attn_alg=alg)


@pytest.mark.parametrize("alg", ["fastmax", "linearmax", "performer"])
def test_reference_state_prefill_matches_no_cache_forward(alg):
    cfg = ref_cfg(alg)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (1, 17)))
    full, _ = gpt.forward(params, cfg, idx)
    logits, _ = gpt.forward_linear_cache(params, cfg, idx, state=gpt.init_linear_cache(cfg, 1),
                                         input_pos=0)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("alg", ["fastmax", "linearmax", "performer"])
def test_reference_recurrent_decode_matches_full_recompute(alg):
    cfg = ref_cfg(alg)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    prompt = np.arange(1, 11, dtype=np.int32)
    seq = list(prompt)
    for _ in range(8):
        logits, _ = gpt.forward(params, cfg, torch.tensor([seq]))
        seq.append(int(torch.argmax(logits[0, -1])))
    ref_new = seq[len(prompt):]
    eng = InferenceEngine(cfg, params, max_seq_length=96, device="cpu")
    got = eng.generate(torch.from_numpy(prompt), len(prompt) + 8)[0, len(prompt):].tolist()
    if alg == "linearmax":
        # the frozen prompt normalisers leave the full renormalisation: the
        # reference holds the first two steps only
        assert got[:2] == ref_new[:2], (got, ref_new)
    else:
        assert got == ref_new, (got, ref_new)


def test_reference_fastmax_prefill_state_continues_correctly():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, (1, 2, 24, 16)))
    z, pre = 8.0 * 16 ** 0.5, 16
    o_pre, state = tfm.fastmax_prefill_state(q[:, :, :pre], k[:, :, :pre], v[:, :, :pre], p=2)
    outs = [o_pre]
    for t in range(pre, 24):
        state, o = tfm.linear_attn_decode_step(state, q[:, :, t], k[:, :, t], v[:, :, t], z, 2)
        outs.append(o[:, :, None])
    ref = tfm.fastmax(q, k, v, mask=True, p=2, chunk=8)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), ref.numpy(), atol=2e-2, rtol=1e-2)


def test_reference_performer_decode_state_matches_training_math():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, (1, 2, 20, 16)))
    o_full = tfm.performer(q, k, v, chunk=8)
    pre = 12
    _, state = tfm.performer_prefill_state(q[:, :, :pre], k[:, :, :pre], v[:, :, :pre])
    outs = []
    for t in range(pre, 20):
        state, o = tfm.performer_decode_step(state, q[:, :, t], k[:, :, t], v[:, :, t])
        outs.append(o[:, :, None])
    got = torch.cat(outs, 2).numpy()
    ref = o_full[:, :, pre:].numpy()
    den = np.einsum("bhnd,bhnd->bhn", q[:, :, pre:].numpy(),
                    np.cumsum(k.numpy(), axis=2)[:, :, pre:] + 1e-6)
    good = np.abs(den) > 0.5
    assert good.any()
    np.testing.assert_allclose(got[good], ref[good], atol=5e-2, rtol=5e-2)
