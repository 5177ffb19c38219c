"""Serving a 4-bit model in every weights mode: the port's quantizers
(fastmax_tpu_torch/ops/quant.py), the plain versions of K8 (``nf4_matmul``)
and K9 (``int4_matmul_tiled``) in ops/quant_kernels.py, ``_fuse_mlp_gates``
and ``_resolve_weights`` of inference/engine.py, the engine and the batcher,
against the JAX package on the CPU (its Pallas kernels in interpret mode).

Codes and converted trees must equal the reference's bit for bit. Kernel
tolerances are the reference's own: atol 2e-4 / rtol 1e-4 for the 4-bit
kernel (tests/test_quant_pallas.py:25), 2e-4 / 2e-3 for tiled int4 (:82);
model logits atol 1e-4 (float32). Inputs carry a non-zero mean, so that a
swapped nibble or a neighbouring block's scale would show. Generation runs a
wider model (n_embd 512, intermediate 768) than the tiny LLaMA of
tests/test_quant_pallas.py:120-123, so that the 4-bit kernel's route takes
three of its linears and leaves mlp.proj (k = 768, not a multiple of 512) to
dequantize + matmul, as Llama-2-7B's k = 11008 is.

The ``cuda`` tests hold K8 and K9 against their plain versions with
chip_smoke.py's checks, and plant faults in a copy of csrc/ that the checks
must catch."""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fastmax_tpu.inference.continuous import ContinuousBatcher as JaxBatcher
from fastmax_tpu.inference.engine import InferenceEngine as JaxEngine
from fastmax_tpu.inference.engine import _fuse_mlp_gates as jax_fuse
from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.ops import quant_pallas as jqp
from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
from fastmax_tpu_torch.inference.engine import InferenceEngine, _fuse_mlp_gates
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
from fastmax_tpu_torch.ops import quant, quant_kernels

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
TINY = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False, parallel_residual=False)  # as Llama-2
WIDE = {**TINY, "n_embd": 512, "intermediate_size": 768}
MODES = ("quantized", "preload", "preload_int8", "preload_int4", "preload_int4_block", "auto")
PROMPT, NEW = 8, 8
NEAR_TIE = 1e-4


@pytest.fixture
def backend():
    """The process-global 4-bit backend, restored after the test."""
    before = quant.get_quant_backend()
    yield quant.set_quant_backend
    quant.set_quant_backend(before)


def _t(tree):
    return from_numpy_params(jax.tree.map(np.asarray, tree), "cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(got: dict, want: dict):
    got, want = _flat(to_numpy_params(got)), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert got[name].dtype == a.dtype and got[name].shape == a.shape, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@functools.lru_cache(maxsize=None)
def _quantized(cfg_name: str, mode: str):
    """(JAX tree, port tree) of the model quantized by the JAX package."""
    cfg = {"tiny": TINY, "wide": WIDE}[cfg_name]
    dense = jgpt.init_params(JaxConfig(**cfg), jax.random.PRNGKey(0), jnp.float32)
    tree = jax.tree.map(np.asarray, jquant.quantize_model(dense, mode))
    return tree, _t(tree)


def _x(rng, shape):
    return (rng.standard_normal(shape) + 0.5).astype(np.float32)


# ------------------------------------------------------------------ quantizers


@pytest.mark.parametrize("kind", ["nf4", "fp4", "int4"])
@pytest.mark.parametrize("dq", [False, True])
def test_quantize_4bit_bit_for_bit(kind, dq):
    w = (np.random.default_rng(0).standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[64:128, :7] = 0.0  # zero blocks take absmax 1
    want = jquant.quantize_4bit(w, kind, double_quant=dq)
    got = quant.quantize_4bit(torch.from_numpy(w), kind, double_quant=dq)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(want)))


def test_quantize_int8_bit_for_bit():
    w = (np.random.default_rng(1).standard_normal((192, 1100)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a zero column takes scale 1
    want = jquant.quantize_int8(w)
    got = quant.quantize_int8(torch.from_numpy(w))
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(want)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int8_matmul_matches_jax(dtype):
    """The unscaled sum stays in f32 until after the scale, as the reference:
    bf16 x gives the reference's bf16 output (one rounding), f32 x its f32."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((512, 384)) * 0.05).astype(np.float32)
    x = _x(rng, (5, 512))
    jp = jquant.quantize_int8(w)
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x, dtype), jp["q8"], jp["scale8"]),
                      np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = quant.int8_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(np.array(jp["q8"])),
                            torch.from_numpy(np.array(jp["scale8"])))
    assert got.dtype == tdt
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:  # f32 sums in two orders may round to neighbouring bf16 values now and then
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=0)
        assert float(np.mean(got.float().numpy() != want)) < 0.02


@pytest.mark.parametrize("scheme", ["rank1", "block"])
@pytest.mark.parametrize("k,n", [(512, 1024), (192, 1100), (100, 300)])
def test_quantize_int4_tiled_bit_for_bit(scheme, k, n):
    """Words, scales, envelopes and the zero-size width markers; k = 100 pads
    to a whole 64-row block."""
    w = (np.random.default_rng(k).standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:64, :5] = 0.0
    want = jquant.quantize_int4_tiled(w, scheme)
    got = quant.quantize_int4_tiled(torch.from_numpy(w), scheme)
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(want)))
    np.testing.assert_array_equal(quant.dequantize(got, torch.bfloat16).float().numpy(),
                                  np.asarray(jquant.dequantize(want, jnp.bfloat16), np.float32))


def test_block_int4_of_nf4_is_biased_upward():
    """Blockwise int4 of an NF4 kernel keeps its absmax and rounds the NF4
    levels x 8 (0.64, 1.29, 1.97, 2.70, 3.53, 4.50, 5.78, ...) mostly upward:
    its error has a positive mean (4.7 % of the mean |w| here) though it is
    smaller than rank-1's (10.9 % and 13.1 % of the norm); rank-1's mean is
    near zero."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((1024, 1024))
                         .astype(np.float32)) * 0.02
    nf4 = quant.dequantize(quant.quantize_4bit(w))
    err = {s: quant.dequantize(quant.quantize_int4_tiled(nf4, s)) - nf4 for s in ("rank1", "block")}
    mean = {s: float(e.mean() / nf4.abs().mean()) for s, e in err.items()}
    size = {s: float(e.norm() / nf4.norm()) for s, e in err.items()}
    assert 0.04 < mean["block"] < 0.055 and abs(mean["rank1"]) < 0.01, mean
    assert 0.1 < size["block"] < size["rank1"] < 0.15, size


@pytest.mark.parametrize("k,n,tile_k", [(512, 1024, None), (192, 1100, None), (1024, 2048, 512)])
def test_torch_packer_equals_pack_int4_tiled(k, n, tile_k):
    codes = np.random.default_rng(0).integers(-8, 8, (k, n)).astype(np.int8)
    got = quant.pack_int4_tiled(torch.from_numpy(codes), tile_k)
    ref = jqp.pack_int4_tiled(codes, tile_k)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert got.numpy().tobytes() == ref.tobytes()
    scales = np.random.default_rng(1).random((k // 64, n)).astype(np.float32)
    np.testing.assert_array_equal(
        quant.tile_scales(torch.from_numpy(scales), ref.shape[2], ref.shape[1] * 1024).numpy(),
        jqp.tile_scales(scales, ref.shape[2], ref.shape[1] * 1024))


def test_rank1_envelope_bit_for_bit():
    absmax = np.random.default_rng(2).random((24, 70)).astype(np.float32) + 1e-3
    absmax[3] = np.float32(1e-12)  # a row of zero blocks, clamped as the quantizer does
    for a, b in zip(quant.rank1_envelope(torch.from_numpy(absmax)), jquant.rank1_envelope(absmax)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


# ------------------------------------------------------------------ plain kernels


@pytest.mark.parametrize("kind", ["nf4", "fp4"])
@pytest.mark.parametrize("m", [1, 8])
def test_nf4_matmul_plain_matches_pallas(kind, m):
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((jqp.TILE_K, jqp.TILE_N)) * 0.05).astype(np.float32)
    p = jquant.quantize_4bit(w, kind=kind)
    x = _x(rng, (m, jqp.TILE_K))
    ref = jqp.nf4_matmul(jnp.asarray(x), p["q4"], p["absmax"], p["code"], interpret=True)
    tp = _t(p)
    got = quant_kernels.nf4_matmul(torch.from_numpy(x), tp["q4"], tp["absmax"], tp["code"])
    assert got.dtype == torch.float32 and got.shape == (m, jqp.TILE_N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def test_nf4_matmul_plain_multi_tile():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((2 * jqp.TILE_K, 2 * jqp.TILE_N)) * 0.05).astype(np.float32)
    p = jquant.quantize_4bit(w, kind="nf4")
    x = _x(rng, (4, 2 * jqp.TILE_K))
    ref = jqp.nf4_matmul(jnp.asarray(x), p["q4"], p["absmax"], p["code"], interpret=True)
    tp = _t(p)
    got = quant_kernels.nf4_matmul_plain(torch.from_numpy(x), tp["q4"], tp["absmax"], tp["code"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["nf4", "int4"])
def test_quantized_matmul_pallas_double_quant(kind):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((jqp.TILE_K, 2 * jqp.TILE_N)) * 0.05).astype(np.float32)
    p = jquant.quantize_4bit(w, kind=kind, double_quant=True)
    x = _x(rng, (2, 3, jqp.TILE_K))
    ref = jqp.quantized_matmul_pallas(jnp.asarray(x), p, interpret=True)
    got = quant_kernels.quantized_matmul_pallas(torch.from_numpy(x), _t(p))
    assert got.shape == (2, 3, 2 * jqp.TILE_N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert quant_kernels.quantized_matmul_pallas(xb, _t(p)).dtype == torch.bfloat16


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("m", [1, 4, 64])
def test_int4_matmul_tiled_plain_matches_pallas(scaled, m):
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((1024, 2048)) * 0.05).astype(np.float32)
    p = jquant.quantize_int4_tiled(w, "block")
    x = _x(rng, (m, 1024))
    s_j = p["scale4"] if scaled else None
    ref = jqp.int4_matmul_tiled(jnp.asarray(x), p["q4b"], s_j, interpret=True)
    tp = _t(p)
    got = quant_kernels.int4_matmul_tiled(torch.from_numpy(x), tp["q4b"],
                                          tp["scale4"] if scaled else None)
    assert got.dtype == torch.float32 and got.shape == (m, 2048)
    tol = 2e-4 if scaled else 2e-4 * 64  # raw nibbles: sums 64x the size of scaled ones
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=2e-3)


@pytest.mark.parametrize("k,n,m", [(192, 1100, 3), (100, 300, 5), (512, 1024, 200)])
def test_int4_matmul_block_matches_pallas(k, n, m):
    """Odd widths padded; m > 128 takes dequantize + matmul in both."""
    rng = np.random.default_rng(k + m)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    p = jquant.quantize_int4_tiled(w, "block")
    x = _x(rng, (1, m, k))
    ref = jqp.int4_matmul_block(jnp.asarray(x), p, interpret=True)
    got = quant_kernels.int4_matmul_block(torch.from_numpy(x), _t(p))
    assert got.shape == (1, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3 if m > 128 else 2e-4,
                               rtol=2e-3)


def _tc_sum(x, pw, s_t, parts, reset=True):
    """K9's tensor-core sum (4 < m <= 64), emulated: x in ``parts`` bf16 parts (f32 x
    in three that add up to it exactly, bf16 x in one), each times the exact codes
    (the tensor cores' products are exact). Each part's 16-row step goes into the
    64-row scale block's f32 sum as one mma adds it: its 16 products summed exactly
    and added with one rounding (to nearest here; the card's adder truncates). Each
    block's sum times s/8 goes into the running f32 sum with one rounding (fmaf).
    ``reset=False`` never clears the block's sum, so each block's scale multiplies
    the running sum of all blocks so far."""
    codes = quant._unpack_int4_tiled(pw).double()
    gk, gn, nb, _ = s_t.shape
    s = s_t.permute(0, 2, 1, 3).reshape(gk * nb, gn * quant.INT4_TILE_N) * 0.125
    hs, rest = [], x.float()
    for _ in range(parts):
        hs.append(rest.to(torch.bfloat16).double())
        rest = rest - hs[-1].float()
    acc = torch.zeros((x.shape[0], codes.shape[1]), dtype=torch.float32)
    blk = torch.zeros_like(acc)
    step = 16
    for b in range(codes.shape[0] // quant.DEFAULT_BLOCK):
        if reset:
            blk = torch.zeros_like(acc)
        for r in range(b * quant.DEFAULT_BLOCK, (b + 1) * quant.DEFAULT_BLOCK, step):
            for h in hs:
                blk = (blk.double() + h[:, r:r + step] @ codes[r:r + step]).float()
        acc = (blk.double() * s[b].double() + acc.double()).float()
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [5, 8, 64])
@pytest.mark.parametrize("k", [4096, 11008])
def test_tc_block_sum_holds_the_f32_gate(k, m, dtype):
    """The arithmetic of K9's tensor-core path (``_tc_sum``) at the 7B depths and
    phase 10's law (weights N(0, 0.05), x N(0.5, 1)) against the JAX kernel in
    interpret mode, with phase 10's f32 gate (chip_smoke.py's INT4_ATOL +
    INT4_RTOL |ref|): f32 x in three parts and bf16 x in one pass. f32 x in its high
    bf16 part alone puts about 40 % of the outputs over the gate, and a block sum
    that is never cleared nearly all of them."""
    rng = np.random.default_rng(k + m)
    w = (rng.standard_normal((k, 1024)) * 0.05).astype(np.float32)
    p = jquant.quantize_int4_tiled(w, "block")
    k_pad = p["q4b"].shape[0] * p["q4b"].shape[2]
    x = np.zeros((m, k_pad), np.float32)
    x[:, :k] = _x(rng, (m, k))
    x = torch.from_numpy(x).to(dtype).float()
    ref = torch.from_numpy(np.array(jqp.int4_matmul_tiled(jnp.asarray(x.numpy()), p["q4b"],
                                                          p["scale4"], interpret=True)))
    tp = _t(p)

    def over(**kw):
        err = (_tc_sum(x, tp["q4b"], tp["scale4"], **kw) - ref).abs()
        return float((err > chip_smoke.INT4_ATOL + chip_smoke.INT4_RTOL * ref.abs()).float()
                     .mean())

    if dtype == torch.bfloat16:
        assert over(parts=1) == 0.0
        return
    assert over(parts=3) == 0.0
    assert over(parts=1) > 0.3
    assert over(parts=3, reset=False) > 0.9


class _Launches:
    """Stands in for a kernel's binding: records the C entry's arguments."""

    def __init__(self):
        self.args = []

    def launch(self, *args):
        self.args.append(args)


@pytest.mark.parametrize("m,path", [(1, "gemv"), (4, "gemv"), (5, "tc"), (8, "tc"), (64, "tc"),
                                    (65, "fma"), (128, "fma")])
@pytest.mark.parametrize("k", [1100, 4096, 11008])
def test_block_launch_takes_the_path(k, m, path, monkeypatch):
    """K9's wrapper passes ``int4_path``'s choice to the C entry (its last int
    argument: 1 for the tensor cores), with that path's split plan: splits that
    cover k and, on the tensor cores, start on 64-row boundaries, so no scale block
    straddles two of them."""
    w = torch.from_numpy(np.random.default_rng(k).standard_normal((k, 1024)).astype(np.float32))
    p = quant.quantize_int4_tiled(w * 0.05, "block")
    launches = _Launches()
    monkeypatch.setitem(quant_kernels.KERNELS, "int4_block_matmul", launches)
    monkeypatch.setattr(quant_kernels, "_sm_count", lambda index: 132)
    quant_kernels._block_launch(torch.zeros((m, k)), p["q4b"], p["scale4"], 1024, torch.float32)
    (args,) = launches.args
    splits, rows, tc = args[-3:]
    assert quant_kernels.int4_path(m, p["q4b"].shape[2]) == path
    assert tc == int(path == "tc")
    assert (splits - 1) * rows < k <= splits * rows
    assert path != "tc" or rows % quant.DEFAULT_BLOCK == 0


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("k,n", [(512, 256), (4096, 22016), (11008, 4096), (128, 96),
                                 (1024, 200)])
def test_pallas_eligible_matches_jax(k, n):
    p = {"q4": np.zeros((k // 2, n), np.uint8)}
    assert quant_kernels.pallas_eligible(p, k, n) == jqp.pallas_eligible(p, k, n)
    assert not quant_kernels.pallas_eligible({"q8": p["q4"]}, k, n)


def test_quantized_matmul_routes(backend, monkeypatch):
    """Under "pallas" an eligible 4-bit linear takes the kernel's route (its
    plain version on the CPU); an ineligible one, x that needs a gradient, and
    the "xla" backend take dequantize + matmul."""
    calls = []
    real = quant_kernels.nf4_matmul_plain
    monkeypatch.setattr(quant_kernels, "nf4_matmul_plain",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    rng = np.random.default_rng(3)
    ok = quant.quantize_4bit(torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32)))
    off = quant.quantize_4bit(torch.from_numpy(rng.standard_normal((768, 256)).astype(np.float32)))
    x, x_off = torch.from_numpy(_x(rng, (3, 512))), torch.from_numpy(_x(rng, (3, 768)))
    backend("pallas")
    y = quant.quantized_matmul(x, ok)
    quant.quantized_matmul(x_off, off)
    quant.quantized_matmul(x.clone().requires_grad_(True), ok)
    assert calls == [(256, 256)]
    backend("xla")
    quant.quantized_matmul(x, ok)
    assert len(calls) == 1
    np.testing.assert_allclose(y.numpy(), (x @ quant.dequantize(ok)).numpy(), atol=2e-4,
                               rtol=1e-4)


def test_autotune_off_the_card_keeps_xla(backend):
    backend("pallas")
    p = quant.quantize_4bit(torch.ones((512, 256)))
    assert quant.autotune_quant_backend(p, torch.zeros((1, 512))) == "xla"
    assert quant.get_quant_backend() == "xla"


# ------------------------------------------------------------------ engine weights


@pytest.mark.parametrize("qmode", ["bnb.nf4", "bnb.int8", "bnb.fp4"])
def test_fuse_mlp_gates_exact(qmode):
    """Fusion is exact for dense, int8 and 4-bit linears and equals the
    reference's fused leaves (tests/test_quant.py:190-223)."""
    cfg = Config(**TINY)
    jp, tp = _quantized("tiny", qmode)
    fused = _fuse_mlp_gates(tp)
    assert "fc_12" in fused["blocks"]["mlp"] and "fc_1" not in fused["blocks"]["mlp"]
    _assert_trees_equal(fused, jax_fuse(jax.tree.map(jnp.asarray, jp)))
    prompt = torch.arange(1, 17)[None]
    for tree in (tp, _t(jax.tree.map(np.asarray, jgpt.init_params(
            JaxConfig(**TINY), jax.random.PRNGKey(0), jnp.float32)))):
        a, _ = gpt.forward(tree, cfg, prompt)
        b, _ = gpt.forward(_fuse_mlp_gates(tree), cfg, prompt)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)


def test_fuse_mlp_gates_skips_double_quant_and_lora():
    _, tp = _quantized("tiny", "bnb.nf4-dq")
    assert _fuse_mlp_gates(tp) is tp
    _, tp = _quantized("tiny", "bnb.nf4")
    mlp = tp["blocks"]["mlp"]
    lora = {**tp, "blocks": {**tp["blocks"], "mlp": {
        **mlp, "fc_1": {**mlp["fc_1"], "lora_A": torch.zeros(2, 128, 4)},
        "fc_2": {**mlp["fc_2"], "lora_A": torch.zeros(2, 128, 4)}}}}
    assert _fuse_mlp_gates(lora) is lora
    eng = InferenceEngine(Config(**TINY), _quantized("tiny", "bnb.nf4-dq")[1],
                          weights_mode="quantized", device="cpu")
    assert "fc_12" not in eng.params["blocks"]["mlp"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qmode", ["bnb.nf4", "bnb.nf4-dq", "bnb.fp4", "bnb.int8", "gptq.int4"])
def test_resolve_weights_matches_jax(qmode, mode):
    """Every leaf of every weights mode equals the JAX package's; "auto"
    equals its "preload_int4" (its chip branch) for a 4-bit tree."""
    jp, tp = _quantized("tiny", qmode)
    want_mode = "preload_int4" if mode == "auto" and qmode != "bnb.int8" else mode
    want = JaxEngine.prepare_params(jax.tree.map(jnp.asarray, jp), want_mode)
    got = InferenceEngine.prepare_params(tp, mode)
    _assert_trees_equal(got, want)


def test_weights_bridge_keeps_tiled_and_int8_leaves():
    """from_numpy_params / to_numpy_params carry q8 codes, q4b words, scale4
    and the stacked zero-size (L, n, 0) markers with their shapes."""
    jp, _ = _quantized("tiny", "bnb.nf4")
    for mode, key, dtype, shape in (("preload_int4_block", "n4", torch.uint8, (2, 512, 0)),
                                    ("preload_int8", "q8", torch.int8, (2, 128, 512))):
        tree = jax.tree.map(np.asarray, JaxEngine.prepare_params(jax.tree.map(jnp.asarray, jp),
                                                                 mode))
        back = _t(tree)
        leaf = back["blocks"]["mlp"]["fc_12"][key]
        assert leaf.dtype == dtype and tuple(leaf.shape) == shape
        _assert_trees_equal(back, tree)


# ------------------------------------------------------------------ generation


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


@pytest.mark.parametrize("mode", ["quantized-xla", "quantized-pallas", "preload", "preload_int8",
                                  "preload_int4", "preload_int4_block"])
def test_generate_matches_jax(mode, backend, monkeypatch):
    """Greedy tokens of the port's engine equal the JAX engine's, and the f32
    prefill logits agree within 1e-4, in every weights mode; the port's
    "quantized" runs under both backends (the JAX engine's dequantizes off its
    chip), its "pallas" one through K8's plain version."""
    weights_mode, _, route = mode.partition("-")
    jp, tp = _quantized("wide", "bnb.nf4")
    jeng = JaxEngine(JaxConfig(**WIDE), jax.tree.map(jnp.asarray, jp), max_seq_length=64,
                     weights_mode=weights_mode)
    teng = InferenceEngine(Config(**WIDE), tp, max_seq_length=64, weights_mode=weights_mode,
                           device="cpu")
    if route:
        backend(route)
    calls = []
    real = quant_kernels.nf4_matmul_plain
    monkeypatch.setattr(quant_kernels, "nf4_matmul_plain", lambda *a: calls.append(1) or real(*a))
    prompt = np.random.default_rng(0).integers(1, 128, (PROMPT,)).astype(np.int32)
    jl, _ = jeng._chunked_prefill(jnp.asarray(prompt)[None], jeng.new_cache())
    tl, _ = teng.prefill(torch.from_numpy(prompt)[None], teng.new_cache())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    ref = np.array(jeng.generate(jnp.asarray(prompt), PROMPT + NEW, temperature=0.0,
                                 key=jax.random.PRNGKey(0)))
    got = teng.generate(torch.from_numpy(prompt), PROMPT + NEW).numpy()
    # qkv, attn.proj and fc_12 per layer and forward; mlp.proj dequantizes
    assert len(calls) == (3 * WIDE["n_layer"] * (1 + NEW) if route == "pallas" else 0)
    diff = np.nonzero(got[0, PROMPT:] != ref[0, PROMPT:])[0]
    if diff.size:
        i = int(diff[0])
        margin = _margins(teng, ref)[i]
        kind = "a near-tie" if margin < NEAR_TIE else "not a near-tie: a fault"
        pytest.fail(f"tokens diverge at generated step {i}: port top-2 margin {margin:.2e} "
                    f"({kind})")
    np.testing.assert_array_equal(got, ref)


def test_batcher_blockwise_int4_matches_engine():
    """The batcher in "preload_int4_block" gives the port engine's tokens."""
    _, tp = _quantized("wide", "bnb.nf4")
    prompts = [np.random.default_rng(s).integers(1, 128, (n,)).astype(np.int32)
               for s, n in ((1, 9), (2, 14), (3, 5))]
    batcher = ContinuousBatcher(Config(**WIDE), tp, n_slots=2, weights_mode="preload_int4_block",
                                device="cpu")
    assert "q4b" in batcher.params["blocks"]["mlp"]["fc_12"]
    rids = [batcher.submit(p, NEW) for p in prompts]
    res = batcher.run_to_completion()
    eng = InferenceEngine(Config(**WIDE), tp, max_seq_length=64,
                          weights_mode="preload_int4_block", device="cpu")
    for rid, p in zip(rids, prompts):
        want = eng.generate(torch.from_numpy(p), len(p) + NEW)[0, len(p):].tolist()
        assert res[rid] == want


@pytest.mark.parametrize("plain", [False, True])
def test_batcher_blockwise_int4_int8_cache_matches_jax(plain):
    """The batcher in "preload_int4_block" with the int8 KV cache gives the
    JAX batcher's greedy tokens on the same tree (its K9 in interpret mode):
    four requests decoding together at m = 4, admitted as one batched wave.
    ``plain`` only routes the port through its plain versions explicitly."""
    jp, tp = _quantized("wide", "bnb.nf4")
    prompts = [np.random.default_rng(s).integers(1, 128, (n,)).astype(np.int32)
               for s, n in ((1, 9), (2, 14), (3, 5), (4, 11))]

    def run(b):
        rids = [b.submit(p, NEW) for p in prompts]
        res = b.run_to_completion()
        return [res[r] for r in rids], b.batched_admissions

    got = run(ContinuousBatcher(Config(**WIDE), tp, n_slots=4, weights_mode="preload_int4_block",
                                cache_dtype=torch.int8, device="cpu", plain=plain))
    want = run(JaxBatcher(JaxConfig(**WIDE), jax.tree.map(jnp.asarray, jp), n_slots=4,
                          weights_mode="preload_int4_block", cache_dtype=jnp.int8))
    assert got == want and got[1] == 4


# ------------------------------------------------------------------ on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 8, 64, 200])
def test_kernels_match_plain_on_the_card(m, dtype):
    """K8 (nf4 and fp4, plain and double-quant scales) and K9 (scaled, raw,
    a ragged k) against their plain versions with chip_smoke.py's checks."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(m)
    before = build.launch_counts()
    chip_smoke.nf4_case(torch, gen, 1024, 768, m, dtype)
    chip_smoke.nf4_case(torch, gen, 512, 256, m, dtype, kind="fp4", dq=True)
    if m <= quant_kernels._INT4_MAX_M:
        chip_smoke.int4_block_case(torch, gen, 1100, 3000, m, dtype)
        chip_smoke.int4_block_case(torch, gen, 1024, 2048, m, dtype, raw=True)
    after = build.launch_counts()
    assert after["nf4_matmul"] - before["nf4_matmul"] == 2
    assert after["int4_block_matmul"] - before["int4_block_matmul"] == (
        2 if m <= quant_kernels._INT4_MAX_M else 0)


# faults planted in a copy of csrc/: (kernel, file, the code as written, as planted)
FAULTS = {
    "K8 nibbles swapped": ("nf4_matmul", "nf4_matmul.cu",
                           "e = code[(b >> 4) & 0xFu]; o = code[b & 0xFu];",
                           "e = code[b & 0xFu]; o = code[(b >> 4) & 0xFu];"),
    "K8 next block's absmax": ("nf4_matmul", "nf4_matmul.cu",
                               "return absmax + static_cast<size_t>(b) * n;",
                               "return absmax + static_cast<size_t>(min(b + 1, nb - 1)) * n;"),
    "K9 scale block off by one": ("int4_block_matmul", "int4_block_matmul.cu",
                                  "const int b = (krow - gki * tk) / kBlock;",
                                  "const int b = min((krow - gki * tk) / kBlock + 1, "
                                  "tk / kBlock - 1);"),
}


# faults planted in the tensor-core kernels of K9 (int4_block_matmul.cu) and K8
# (nf4_matmul.cu): (the code as written, as planted, the (k, n, m) of
# int4_block_case or nf4_case at f32 x that must fail). K9's B mask is seen only
# where a 16-row step runs past k: k = 1100 (k_pad 1536); an uncleared block sum
# only where a warp takes two blocks or more of a split: for K9 at k = 11008 and m = 8
# (splits of 704 rows), not at k = 4096 (256 rows, one each); for K8, whose warps walk
# every block of their split, at k = 11008 and m = 8 (6 blocks a split).
TC_FAULTS = {
    "K9 only the high part of f32 x": (
        "for (int e = 0; e < kParts; ++e) mma_bf16(blk[p], a, b[0][e], b[1][e]);",
        "for (int e = 0; e < 1; ++e) mma_bf16(blk[p], a, b[0][e], b[1][e]);", (4096, 4096, 8)),
    "K9 block sum not reset between blocks": (
        "for (int j = 0; j < 4; ++j) blk[p][j] = 0.f;  // a fresh sum for each scale block",
        "for (int j = 0; j < 4; ++j) blk[p][j] = kb == k0 + warp * kBlock ? 0.f : blk[p][j];",
        (11008, 4096, 8)),
    "K9 last 16-row step of a split skipped": (
        "if (ks >= k1) break;", "if (ks + kTcStep >= k1) break;", (11008, 4096, 8)),
    "K9 B not zeroed at rows >= k": ("xv[r] = xrow_ok && kr < k ? val : 0.f;",
                                     "xv[r] = xrow_ok ? val : 0.f;", (1100, 3000, 8)),
    "K8 only the first code part": (
        "for (int e = 0; e < kCodeParts; ++e) mma_bf16(blk[j], a[e], bx[0][0], bx[1][0]);",
        "for (int e = 0; e < 1; ++e) mma_bf16(blk[j], a[e], bx[0][0], bx[1][0]);",
        (4096, 4096, 8)),
    "K8 only the high part of f32 x": (
        "if (kXParts == 2) mma_bf16(blk[j], a[0], bx[0][1], bx[1][1]);",
        "if (kXParts == 0) mma_bf16(blk[j], a[0], bx[0][1], bx[1][1]);", (4096, 4096, 8)),
    "K8 block sum not reset between blocks": (
        "for (int e = 0; e < 4; ++e) blk[j][e] = 0.f;  // a fresh sum for each quant block",
        "for (int e = 0; e < 4; ++e) blk[j][e] = b == b0 ? 0.f : blk[j][e];", (11008, 4096, 8)),
}
# the kernel, its source and the check of each tensor-core fault, by the fault's prefix
TC_KERNELS = {"K9": ("int4_block_matmul", "int4_block_matmul.cu", "int4_block_case"),
              "K8": ("nf4_matmul", "nf4_matmul.cu", "nf4_case")}


def _planted(tmp_path, name, source, written, planted):
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    text = (src / source).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {source} once"
    (src / source).write_text(text.replace(written, planted))
    real = build.KERNELS[name]
    return name, build.Kernel(name, str(src / source), real.replaces, real.entry, real.argtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_planted_fault(fault, m, tmp_path, monkeypatch):
    """chip_smoke.py's checks fail for a K8 built with its nibbles swapped or
    reading the next block's absmax, and for a K9 reading the next block's
    scales, in the streaming (m = 1) and the tensor-core (m = 64) regime (the
    gemv's and the tensor-core kernel's code reads the planted lines)."""
    _needs_card()
    name, faulty = _planted(tmp_path, *FAULTS[fault])
    gen = torch.Generator(device="cuda").manual_seed(7)
    case = (chip_smoke.nf4_case if name == "nf4_matmul" else chip_smoke.int4_block_case)
    case(torch, gen, 1024, 2048, m, torch.float32)  # sound
    monkeypatch.setitem(build.KERNELS, name, faulty)
    with pytest.raises(AssertionError, match=fault[:2]) as caught:
        case(torch, gen, 1024, 2048, m, torch.float32)
    print(f"{fault}, m={m}: {caught.value}")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(TC_FAULTS))
def test_checks_catch_a_planted_tc_fault(fault, tmp_path, monkeypatch):
    """chip_smoke.py's K9 check fails for a tensor-core kernel that keeps only the
    high bf16 part of f32 x, never clears a scale block's sum, skips the last
    16-row step of each split, or lets the rows past k (random words) into the sum
    with x of column k - 1 (seen where k % 16 != 0); its K8 check for a tensor-core
    kernel that multiplies only the first bf16 part of the codes or only the high
    part of f32 x, or never clears a quant block's sum."""
    _needs_card()
    written, planted, (k, n, m) = TC_FAULTS[fault]
    kernel, source, check = TC_KERNELS[fault[:2]]
    name, faulty = _planted(tmp_path, kernel, source, written, planted)
    gen = torch.Generator(device="cuda").manual_seed(7)
    case = getattr(chip_smoke, check)
    assert (quant_kernels.nf4_path(m) if kernel == "nf4_matmul"
            else quant_kernels.int4_path(m, k + (-k) % 512)) == "tc"
    case(torch, gen, k, n, m, torch.float32)  # sound
    monkeypatch.setitem(build.KERNELS, name, faulty)
    with pytest.raises(AssertionError, match=fault[:2]) as caught:
        case(torch, gen, k, n, m, torch.float32)
    print(f"{fault}: {caught.value}")


def test_kernel_sources_hold_the_planted_lines():
    """The lines the card's fault tests plant faults in are in the sources
    once each (so a rewrite of a kernel does not silently disarm them)."""
    planted = list(FAULTS.values()) + [
        (*TC_KERNELS[fault[:2]][:2], written, planted)
        for fault, (written, planted, _) in TC_FAULTS.items()]
    for name, source, written, _ in planted:
        assert (build.CSRC_DIR / source).read_text().count(written) == 1, (source, written)
        assert build.KERNELS[name].source.name == source
    assert TC_FAULTS["K9 B not zeroed at rows >= k"][2][0] % 16  # a step runs past k
