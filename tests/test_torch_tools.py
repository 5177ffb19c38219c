"""The int4/NF4 kernel labs (fastmax_tpu_torch/tools/) against the scripts of
tools/ on the CPU: every function that reaches ``pl.pallas_call`` there
(T1-T4), through the port's plain versions, on the same numpy inputs.

The scripts take no ``interpret`` argument (and ``m8_matmul`` passes
``interpret=False``), so each test points the script module's ``pl`` at a
namespace whose ``pallas_call`` runs in interpret mode, as the JAX package's
own tests run its kernels; the scripts are not edited. tools/nf4_lab_r04.py
points JAX's persistent cache elsewhere when it is imported: the fixture that
imports it restores the three settings.

Inputs: x with mean 0.5, codes uniform over their 16 values, absmax varying
across blocks (0.01-0.03), so that a swapped nibble, a neighbouring block's
scale or a missing rounding shows. Tolerance: the reference's tiled-int4 one
(atol 2e-4, rtol 2e-3, tests/test_quant_pallas.py:82), atol scaled by the
largest |output|; the probes and the packers must be exact. The routes that
map a lab function onto an already ported kernel (K1, K8, K9) are checked by
counting the plain versions they reach.

The ``cuda`` tests hold K10-K13 against their plain versions with
chip_smoke.py's checks and plant faults in a copy of csrc/ that the checks
must catch."""

import contextlib
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

import chip_smoke
from fastmax_tpu.ops import quant_pallas as jqp
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import quant, quant_kernels
from fastmax_tpu_torch.tools import int4_opt_r04 as t04
from fastmax_tpu_torch.tools import int4_opt_r05 as t05
from fastmax_tpu_torch.tools import lab_kernels
from fastmax_tpu_torch.tools import nf4_lab_r04 as tlab
from fastmax_tpu_torch.tools import nf4_variants_r04 as tv
from tools import int4_opt_r04 as j04
from tools import int4_opt_r05 as j05
from tools import nf4_variants_r04 as jv

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
ATOL, RTOL = 2e-4, 2e-3
K, N = 1024, 2048
REPO = Path(__file__).resolve().parent.parent


class _Interpret:
    """``pallas`` with every ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(jpl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return jpl.pallas_call(*args, **{**kw, "interpret": True})


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    for mod in (j04, j05, jv):
        monkeypatch.setattr(mod, "pl", _Interpret())


@pytest.fixture(scope="module")
def jlab():
    """tools/nf4_lab_r04.py, imported with JAX's cache settings restored."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {name: getattr(jax.config, name) for name in names}
    try:
        mod = importlib.import_module("tools.nf4_lab_r04")
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
    mod.pl = _Interpret()
    return mod


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL * float(np.abs(want).max()), rtol=RTOL)


def _x(m, k, seed=0):
    return (np.random.default_rng(seed).standard_normal((m, k)) + 0.5).astype(np.float32)


def _tiled(k=K, n=N, tile_k=None, seed=1):
    codes = np.random.default_rng(seed).integers(-8, 8, (k, n))
    return jqp.pack_int4_tiled(codes, tile_k)


def _q4(k, n, seed=2):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (k // 2, n)).astype(np.uint8)
    absmax = rng.uniform(0.01, 0.03, (k // 64, n)).astype(np.float32)
    return packed, absmax


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------- T1, T2: raw nibbles


@pytest.mark.parametrize("m", [1, 8])
def test_onedot_matmul(m):
    """T1a, int4_opt_r04.py:104: words packed at tk = 1024."""
    pw, x = _tiled(tile_k=1024), _x(m, K)
    want = j04.onedot_matmul(jnp.asarray(x), jnp.asarray(pw))
    _close(t04.onedot_matmul(*_t(x, pw)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_m8_matmul(dtype):
    """T1b, int4_opt_r04.py:145 (its interpret=False overridden), m = 8."""
    pw, x = _tiled(), _x(8, K)
    want = j04.m8_matmul(jnp.asarray(x), jnp.asarray(pw), dtype=getattr(jnp, dtype))
    _close(t04.m8_matmul(*_t(x, pw), dtype=getattr(torch, dtype)), want)


def test_xla_unpack_matmul():
    """The lab's plain variant (XLA in the reference, plain PyTorch here)."""
    codes = np.random.default_rng(3).integers(-8, 8, (K, 1024))
    q = (codes & 0xF).astype(np.uint32).reshape(K // 8, 8, 1024)
    words = np.zeros((K // 8, 1024), np.uint32)
    for p in range(8):
        words |= q[:, p, :] << (4 * p)
    w32 = words.view(np.int32)
    x = _x(1, K)
    want = j04.xla_unpack_matmul(jnp.asarray(x), jnp.asarray(w32))
    _close(t04.xla_unpack_matmul(*_t(x, w32)), want)
    assert t04._pack_along_k(torch.from_numpy(codes), K).numpy().tobytes() == w32.tobytes()


@pytest.mark.parametrize("m", [1, 8])
def test_sem_matmul(m):
    """T2a, int4_opt_r05.py:111, at the packer's default tk and at tk 512."""
    for tile_k in (None, 512):
        pw, x = _tiled(tile_k=tile_k), _x(m, K)
        _close(t05.sem_matmul(*_t(x, pw)), j05.sem_matmul(jnp.asarray(x), jnp.asarray(pw)))


@pytest.mark.parametrize("onedot", [False, True])
@pytest.mark.parametrize("m", [1, 8])
def test_bf16_matmul(m, onedot):
    """T2b, int4_opt_r05.py:158: bf16 x and planes, f32 sums."""
    pw, x = _tiled(), _x(m, K)
    want = j05.bf16_matmul(jnp.asarray(x), jnp.asarray(pw), onedot=onedot)
    _close(t05.bf16_matmul(*_t(x, pw), onedot=onedot), want)


@pytest.mark.parametrize("tile_k", [None, 512])
def test_stream_ref_exact(tile_k):
    """T2c, int4_opt_r05.py:188: the probe's output bit for bit (int32 words
    rounded to f32, summed over k tiles in order)."""
    pw = np.random.default_rng(4).integers(-2**31, 2**31 - 1, (K // (tile_k or K), 2,
                                                               tile_k or K, 128)).astype(np.int32)
    want = np.asarray(j05.stream_ref(jnp.asarray(pw)))
    got = t05.stream_ref(torch.from_numpy(pw)).numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------- T3: NF4 / int4 variants


@pytest.mark.parametrize("k", [1024, 576])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5"])
def test_run_nf4_variants(variant, m, k):
    """T3a, nf4_variants_r04.py:123; k = 576 halves the k tile to 64."""
    packed, absmax = _q4(k, 1024)
    x = _x(m, k)
    w = {"q4": packed, "absmax": absmax}
    want = jv.get(variant, k, 1024)(jnp.asarray(x), {kk: jnp.asarray(v) for kk, v in w.items()})
    got = tv.get(variant, k, 1024)(torch.from_numpy(x), dict(zip(w, _t(*w.values()))))
    _close(got, want)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("variant", ["v6", "v7"])
def test_run_int4_variants(variant, m):
    """T3b, nf4_variants_r04.py:208: linear int4 on the q4 bytes, bf16 x."""
    packed, absmax = _q4(K, 1024)
    x = _x(m, K)
    want = jv.get_int4(variant, K, 1024)(jnp.asarray(x), {"q4": jnp.asarray(packed),
                                                          "absmax": jnp.asarray(absmax)})
    got = tv.get_int4(variant, K, 1024)(torch.from_numpy(x), dict(zip(("q4", "absmax"),
                                                                     _t(packed, absmax))))
    _close(got, want)


def _colnibble(variant, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (K, N)).astype(np.uint8)
    absmax = rng.uniform(0.01, 0.03, (K // 64, N)).astype(np.float32)
    jpack = jv.pack_v8 if variant == "v8" else jv.pack_v9
    tpack = tv.pack_v8 if variant == "v8" else tv.pack_v9
    pw, s = jpack(q, absmax)
    pw2, s2 = tpack(q, absmax)
    assert pw.tobytes() == pw2.tobytes() and s.tobytes() == s2.tobytes()
    return pw, s


_V10_SCRIPT = """
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental import pallas as pl
import tools.nf4_variants_r04 as jv

class Interpret:
    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return pl.pallas_call(*args, **{**kw, "interpret": True})

jv.pl = Interpret()
d = np.load(sys.argv[1])
f = jv.get_v10("v10", int(d["k"]), int(d["n"]))
w = {"pw": jnp.asarray(d["pw"]), "s": jnp.asarray(d["s"])}
np.savez(sys.argv[2], **{m: np.asarray(f(jnp.asarray(d[m]), w)) for m in ("1", "8")})
"""


@pytest.fixture(scope="module")
def v10_reference(tmp_path_factory):
    """The reference's v10 at m = 1 and 8 on the CPU with XLA's excess
    precision off: its ``bf16(q) * bf16(s/8)`` is a bf16 product, which XLA's
    CPU backend otherwise keeps in f32 (``--xla_allow_excess_precision``, on
    by default), so that interpret mode would not round where the kernel's
    program does. One subprocess, since the flag is read when XLA starts."""
    tmp = tmp_path_factory.mktemp("v10")
    pw, s = _colnibble("v10")
    np.savez(tmp / "in.npz", pw=pw, s=s, k=K, n=N, **{str(m): _x(m, K) for m in (1, 8)})
    env = {key: v for key, v in os.environ.items() if not key.startswith(("JAX", "XLA"))}
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _V10_SCRIPT, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    refs = np.load(tmp / "out.npz")
    return {int(m): refs[m] for m in refs.files}


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("variant", ["v8", "v9", "v10", "v11"])
def test_run_colnibble_variants(variant, m, v10_reference):
    """T3c-e, nf4_variants_r04.py:289 (v8), :355 (v9), :440 (v10, v11), over
    two 1024-column tiles; the packers equal the script's bit for bit."""
    pw, s = _colnibble(variant)
    x = _x(m, K)
    if variant == "v10":
        want = v10_reference[m]
    else:
        jf = {"v8": jv.get_v8(K, N), "v9": jv.get_v9(K, N)}.get(variant) or jv.get_v10(
            variant, K, N)
        want = jf(jnp.asarray(x), {"pw": jnp.asarray(pw), "s": jnp.asarray(s)})
    tf = {"v8": tv.get_v8(K, N), "v9": tv.get_v9(K, N)}.get(variant) or tv.get_v10(variant, K, N)
    _close(tf(torch.from_numpy(x), dict(zip(("pw", "s"), _t(pw, s)))), want)


def test_v10_rounds_its_product(v10_reference):
    """v10's w = bf16(bf16(q) * bf16(s/8)) rounds, and the plain version
    rounds where the reference does: without the rounding it misses."""
    pw, s = _colnibble("v10")
    x = _x(8, K)
    want = v10_reference[8]
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    q = lab_kernels._colnibble_codes(torch.from_numpy(pw), False)
    sb = (torch.from_numpy(s) * 0.125).to(torch.bfloat16).float().repeat_interleave(64, 0)
    unrounded = torch.matmul(xb, q * sb).numpy()
    with pytest.raises(AssertionError):
        _close(unrounded, want)


@pytest.mark.parametrize("m", [1, 8])
def test_run_v9t_is_k9_scaled(m):
    """T3f, nf4_variants_r04.py:514, through K9 with scales; pack_v9t equals
    the port's pack_int4_tiled of the signed codes and tile_scales."""
    rng = np.random.default_rng(6)
    q = rng.integers(0, 16, (K, N)).astype(np.uint8)
    absmax = rng.uniform(0.01, 0.03, (K // 64, N)).astype(np.float32)
    pw_t, s_t = jv.pack_v9t(q, absmax, tk=512)
    pw2, s2 = tv.pack_v9t(q, absmax, tk=512)
    assert pw_t.tobytes() == pw2.tobytes() and s_t.tobytes() == s2.tobytes()
    assert pw_t.tobytes() == quant.pack_int4_tiled(q.astype(np.int32) - 8, 512).tobytes()
    assert s_t.tobytes() == quant.tile_scales(torch.from_numpy(absmax), 512, N).numpy().tobytes()
    x = _x(m, K)
    want = jv.get_v9t(K, N, tk=512)(jnp.asarray(x), {"pw": jnp.asarray(pw_t),
                                                     "s": jnp.asarray(s_t)})
    _close(tv.get_v9t(K, N, tk=512)(torch.from_numpy(x), dict(zip(("pw", "s"),
                                                                   _t(pw_t, s_t)))), want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m", [1, 8])
def test_run_v12(m, bf16):
    """T3g, nf4_variants_r04.py:571: ((x u) @ Q) v / 8, f32 (K1's function)
    and bf16 (K10 on bf16(x u))."""
    rng = np.random.default_rng(7)
    pw = _tiled(tile_k=1024, seed=8)
    u = rng.uniform(0.5, 2.0, K).astype(np.float32)
    v = rng.uniform(0.5, 2.0, N).astype(np.float32)
    x = _x(m, K)
    w = {"pw": pw, "u": u, "v": v}
    want = jv.get_v12(K, N, bf16=bf16)(jnp.asarray(x), {kk: jnp.asarray(a)
                                                        for kk, a in w.items()})
    _close(tv.get_v12(K, N, bf16=bf16)(torch.from_numpy(x), dict(zip(w, _t(*w.values())))),
           want)


def test_rank1_envelope_bit_for_bit():
    absmax = np.random.default_rng(9).uniform(0.01, 0.03, (16, 512)).astype(np.float32)
    for a, b in zip(jv.rank1_envelope(absmax), tv.rank1_envelope(absmax)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_reference_shape_faults_raise():
    """A shape on which the reference asserts, or whose weights' tiles differ
    from the call's, raises here (the lab prints an error line): v8 at n %
    1024 != 0; v9t and v12 on words drawn at tk 512 where the call halves its
    tile to 64 (k = 1088); v12 with v wider than its column tiles."""
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError):
        tv.get_v8(K, 1536)(torch.zeros((1, K)), {"pw": torch.zeros((K, 192), **i32),
                                                 "s": torch.zeros((K // 64, 1536))})
    pw = torch.zeros((2, 2, 512, 128), **i32)
    with pytest.raises(ValueError):
        tv.get_v9t(1088, N, tk=512)(torch.zeros((1, 1088)),
                                    {"pw": pw, "s": torch.zeros((2, 2, 8, 1024))})
    for bf16 in (False, True):
        with pytest.raises(ValueError):
            tv.get_v12(1088, N, tk=512, bf16=bf16)(
                torch.zeros((1, 1088)), {"pw": pw, "u": torch.ones(1088), "v": torch.ones(N)})
        with pytest.raises(ValueError):
            tv.get_v12(K, 2500, bf16=bf16)(
                torch.zeros((1, K)), {"pw": torch.zeros((1, 2, K, 128), **i32),
                                      "u": torch.ones(K), "v": torch.ones(2500)})


# ---------------------------------------------------------------- T4 and the lab


@pytest.mark.parametrize("k,tk,tn", [(1024, 512, 256), (1088, 512, 256), (1024, 256, 512)])
def test_stream_bytes_exact(jlab, k, tk, tn):
    """T4, nf4_lab_r04.py:159, bit for bit: k = 1088 leaves rows past the
    last whole tile unread, as the Pallas grid does."""
    packed, absmax = _q4(k, 1024, seed=10)
    want = np.asarray(jlab.stream_bytes(jnp.asarray(packed), jnp.asarray(absmax), tk=tk, tn=tn))
    got = tlab.stream_bytes(*_t(packed, absmax), tk=tk, tn=tn).numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    ref = np.zeros((1, 1024), np.float32)
    for j in range((2 * packed.shape[0]) // tk):
        cs = packed[j * tk // 2:(j + 1) * tk // 2].astype(np.int64).sum(0).astype(np.float32)
        ref += cs + absmax[j * tk // 64]
    assert got.tobytes() == ref.tobytes()


def test_lab_tables_match(jlab):
    assert tlab.SHAPES == jlab.SHAPES and tlab.WSET == jlab.WSET
    assert tlab.TOTAL_REPS == jlab.TOTAL_REPS
    for impl in ("bf16", "int8", "int4", "nf4_xla", "v3"):
        for k, n in tlab.SHAPES.values():
            assert tlab.bytes_read(impl, k, n) == jlab.bytes_read(impl, k, n)
    assert t04.SHAPES_7B == j04.SHAPES_7B and t05.SHAPES_7B == j05.SHAPES_7B
    assert tlab.calibrate() == 0.0


def test_int8_impl_matches_jax(jlab):
    """The lab's int8 impl: the port's int8_matmul on bf16 x, one rounding."""
    rng = np.random.default_rng(11)
    q8 = rng.integers(-127, 128, (K, 256)).astype(np.int8)
    scale = np.full((256,), 2e-3, np.float32)
    x = _x(2, K)
    want = np.asarray(jlab.quant.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q8),
                                             jnp.asarray(scale)), np.float32)
    got = quant.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), *_t(q8, scale))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=0)


# ---------------------------------------------------------------- the mapped routes


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def test_routes_reach_k8_k9_k1(monkeypatch):
    """onedot, sem and f32 m8 take K9's raw mode; v9t K9 with scales; v3/v4
    K8 (also at k % 512 != 0: k = 576); f32 v12 K1; the bf16 functions K10,
    v1/v2/v5/v6/v7 K11, v8-v11 K12."""
    k9 = _counting(monkeypatch, quant_kernels, "int4_matmul_tiled_plain")
    k8 = _counting(monkeypatch, quant_kernels, "nf4_matmul_plain")
    k1 = _counting(monkeypatch, quant_kernels, "int4_matmul_rank1_plain")
    k10 = _counting(monkeypatch, lab_kernels, "int4_tiled_bf16_plain")
    k11 = _counting(monkeypatch, lab_kernels, "q4_byte_matmul_plain")
    k12 = _counting(monkeypatch, lab_kernels, "colnibble_matmul_plain")
    pw, x1, x8 = _tiled(), torch.from_numpy(_x(1, K)), torch.from_numpy(_x(8, K))
    pw_t = torch.from_numpy(pw)
    t04.onedot_matmul(x1, pw_t), t05.sem_matmul(x1, pw_t), t04.m8_matmul(x8, pw_t)
    assert len(k9) == 3
    t04.m8_matmul(x8, pw_t, torch.bfloat16), t05.bf16_matmul(x1, pw_t)
    assert len(k10) == 2
    packed, absmax = _q4(576, 1024)
    w = dict(zip(("q4", "absmax"), _t(packed, absmax)))
    for v in ("v3", "v4"):
        tv.get(v, 576, 1024)(torch.from_numpy(_x(1, 576)), w)
    assert len(k8) == 2
    for v in ("v1", "v2", "v5"):
        tv.get(v, 576, 1024)(torch.from_numpy(_x(1, 576)), w)
    for v in ("v6", "v7"):
        tv.get_int4(v, 576, 1024)(torch.from_numpy(_x(1, 576)), w)
    assert len(k11) == 5 and len(k8) == 2
    pw8, s8 = _colnibble("v9")
    for v in ("v8", "v9", "v10", "v11"):
        tv.get_v10(v, K, N)(x1, dict(zip(("pw", "s"), _t(pw8, s8)))) if v in ("v10", "v11") \
            else (tv.get_v8 if v == "v8" else tv.get_v9)(K, N)(x1, dict(zip(("pw", "s"),
                                                                             _t(pw8, s8))))
    assert len(k12) == 4
    tv.get_v12(K, N)(x1, {"pw": torch.from_numpy(_tiled(tile_k=1024, seed=8)),
                          "u": torch.ones(K), "v": torch.ones(N)})
    assert len(k1) == 1


# ---------------------------------------------------------------- on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 11])
def test_lab_kernels_match_plain_on_the_card(m):
    """K10-K13 against their plain versions with chip_smoke.py's checks, at a
    small shape, every mode."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(m)
    for case in chip_smoke.lab_cases(2048, 3072, m):
        chip_smoke.lab_case(torch, gen, *case)


# faults planted in a copy of csrc/: (kernel, file, the code as written, as planted, the case
# that must catch it (kernel, mode, k, n), the path that reads the planted line, and the rows of
# x at which it must be caught there). At m = 8, where lab_path picks the tensor cores, a gemv
# fault is caught on the earlier route (chip_smoke.earlier_route: the gemv at every m). The
# tensor-core faults are those tests/test_torch_lab_tc.py plants in its emulation; a block sum
# never cleared shows only where a warp takes several 64-row blocks of its split (k = 11008).
# K10 has one kernel ("tc": the tensor cores at every m) and K13 one a mode ("probe"); their
# faults are those tests/test_torch_lab_k10.py plants in its emulation of K10's sums, and one
# tile of stream_bytes left out of the tile-order sum, which the exact check catches. The rows
# of x past m feed only the outputs past m, so their mask that matters is where the block
# writes its sums, compact (rows floats a column): unmasked, at m = 5 rows 5-7 of a column
# land on rows 0-2 of the next, after its own where the next is another thread's.
FAULTS = {
    "K10 nibble planes swapped": (
        "int4_tiled_bf16", "int4_tiled_bf16.cu",
        "const int col = gni * kTileN + (c / kUnitLanes) * kLanes + lane0 + c % kUnitLanes;",
        "const int col = gni * kTileN + ((c / kUnitLanes) ^ 1) * kLanes + lane0 + c % "
        "kUnitLanes;", ("K10", "raw", 4096, 4096), "tc", (1, 8)),
    "K10 one split left out": (
        "int4_tiled_bf16", "int4_tiled_bf16.cu",
        "if (sp < splits) sum += v[sp][q];  // the splits in order",
        "if (sp > 0 && sp < splits) sum += v[sp][q];  // the splits in order",
        ("K10", "raw", 4096, 12288), "tc", (8,)),
    "K10 rows past m not masked": (
        "int4_tiled_bf16", "int4_tiled_bf16.cu",
        "if (i < rows) red[warp * kCols * kMChunk + c * rows + i] = acc[p][j];",
        "red[warp * kCols * kMChunk + c * rows + i] = acc[p][j];",
        ("K10", "raw", 4096, 4096), "tc", (5,)),
    "K13 stream_bytes one tile left out": (
        "stream_probe", "stream_probe.cu", "if (j0 + u < tiles) sum += v[u];",
        "if (j0 + u < tiles && j0 + u != 1) sum += v[u];", ("K13", "stream_bytes", 4096, 4096),
        "probe", (1,)),
    "K11 nibbles swapped": ("q4_byte_matmul", "q4_byte_matmul.cu",
                            "e = table[(b >> 4) & 0xFu]; o = table[b & 0xFu];",
                            "e = table[b & 0xFu]; o = table[(b >> 4) & 0xFu];",
                            ("K11", "v1", 4096, 2048), "gemv", (1, 8)),
    "K12 next block's scale": ("int4_colnibble_matmul", "int4_colnibble_matmul.cu",
                               "sc[p] = plane_scale(s, b, n, colbase + p * kLanes, mode);",
                               "sc[p] = plane_scale(s, min(b + 1, nb - 1), n, colbase + p * "
                               "kLanes, mode);", ("K12", "v9", 4096, 2048), "gemv", (1, 8)),
    "K12 v10 unrounded": ("int4_colnibble_matmul", "int4_colnibble_matmul.cu",
                          "wq = __bfloat162float(__float2bfloat16(wq * sc[p]));",
                          "wq *= sc[p];", ("K12", "v10", 4096, 2048), "gemv", (1, 8)),
    "K11 tc first code part alone": (
        "q4_byte_matmul", "q4_byte_matmul.cu",
        "for (int e = 0; e < kCodeParts; ++e) mma_bf16(blk[j], a[e], bx[0][0], bx[1][0]);",
        "for (int e = 0; e < 1; ++e) mma_bf16(blk[j], a[e], bx[0][0], bx[1][0]);",
        ("K11", "v1", 4096, 2048), "tc", (8,)),
    "K11 tc high part of x alone": (
        "q4_byte_matmul", "q4_byte_matmul.cu",
        "if (kXParts == 2) mma_bf16(blk[j], a[0], bx[0][1], bx[1][1]);",
        "if (kXParts == 0) mma_bf16(blk[j], a[0], bx[0][1], bx[1][1]);",
        ("K11", "v1", 4096, 2048), "tc", (8,)),
    "K11 tc block sum not reset": (
        "q4_byte_matmul", "q4_byte_matmul.cu",
        "for (int e = 0; e < 4; ++e) blk[j][e] = 0.f;  // a fresh sum for each absmax block",
        "for (int e = 0; e < 4; ++e) blk[j][e] = b == b0 ? 0.f : blk[j][e];",
        ("K11", "v7", 11008, 2048), "tc", (8,)),
    "K12 tc high part of x alone": (
        "int4_colnibble_matmul", "int4_colnibble_matmul.cu",
        "for (int e = 0; e < kParts; ++e) mma_bf16(blk[p], a, bx[0][e], bx[1][e]);",
        "for (int e = 0; e < 1; ++e) mma_bf16(blk[p], a, bx[0][e], bx[1][e]);",
        ("K12", "v8", 4096, 2048), "tc", (8,)),
    "K12 tc v10 scale out of the product": (
        "int4_colnibble_matmul", "int4_colnibble_matmul.cu",
        "constexpr bool kScaleInA = MODE == 2;", "constexpr bool kScaleInA = false;",
        ("K12", "v10", 4096, 2048), "tc", (8,)),
    "K12 tc v8 without the XOR": (
        "int4_colnibble_matmul", "int4_colnibble_matmul.cu",
        "const uint32_t flip = MODE == 0 ? 0x88888888u : 0u;", "const uint32_t flip = 0u;",
        ("K12", "v8", 4096, 2048), "tc", (8,)),
    "K12 tc block sum not reset": (
        "int4_colnibble_matmul", "int4_colnibble_matmul.cu",
        "for (int j = 0; j < 4; ++j) blk[p][j] = 0.f;  // a fresh sum for each scale block",
        "for (int j = 0; j < 4; ++j) blk[p][j] = b == b0 + warp ? 0.f : blk[p][j];",
        ("K12", "v11", 11008, 2048), "tc", (8,)),
}


def _planted(tmp_path, source, written, planted, name):
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    text = (src / source).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {source} once"
    (src / source).write_text(text.replace(written, planted))
    real = build.TOOL_KERNELS[name]
    return build.Kernel(name, str(src / source), real.replaces, real.entry, real.argtypes)


def _on_path(kern, path, m):
    """The route on which ``path`` takes m rows: the gemv at m > 4 on the earlier route."""
    if path == "gemv" and m > lab_kernels.LAB_GEMV_MAX_M:
        return chip_smoke.earlier_route(lab_kernels, kern)
    return contextlib.nullcontext()


@pytest.mark.cuda
@pytest.mark.parametrize("fault,m", [(f, m) for f in sorted(FAULTS) for m in FAULTS[f][6]])
def test_checks_catch_a_planted_fault(fault, m, tmp_path, monkeypatch):
    """chip_smoke.py's check fails for K11 with its nibbles swapped, K12
    reading the next block's scale, and K12's v10 without its bf16 product
    rounding, on the gemv; and, on the tensor cores, for K11 with only the
    first bf16 part of the codes, only the high part of x, or a block sum
    never cleared, and for K12 with only the high part of x, v10's scale out
    of the product, v8's words not XORed, or a block sum never cleared; for
    K10 with its nibble planes swapped, one split left out of the split-order
    sum, or the rows of x past m written unmasked (m = 5); and for K13's
    stream_bytes with one tile left out of the tile-order sum."""
    _needs_card()
    name, source, written, planted, (kern, v, k, n), path, _ = FAULTS[fault]
    faulty = _planted(tmp_path, source, written, planted, name)
    gen = torch.Generator(device="cuda").manual_seed(7)
    with _on_path(kern, path, m):
        assert kern in ("K10", "K13") or lab_kernels.lab_path(m, n) == path
        chip_smoke.lab_case(torch, gen, kern, v, k, n, m)  # sound
        monkeypatch.setitem(build.TOOL_KERNELS, name, faulty)
        with pytest.raises(AssertionError, match=fault[:3]) as caught:
            chip_smoke.lab_case(torch, gen, kern, v, k, n, m)
    print(f"{fault}, m={m}: {caught.value}")


# the line that folds every load of stream_ref into the checksum: removed, the loads feed
# nothing and the compiler drops them
PROBE_FAULT = ("for (int u = 0; u < kUnroll; ++u) h ^= fold(v[u]);  // every load into the "
               "checksum", "")


@pytest.mark.cuda
def test_rate_check_catches_a_probe_that_skips_rows(tmp_path, monkeypatch):
    """A K13 whose stream_ref folds none of its loads into the checksum keeps
    its output (the reference's row 0, read apart) but reads far less than it
    claims: the rate check of chip_smoke.py fails it, while the sound probe
    passes. At 512 MB, where the launch's fixed cost is small beside the
    read."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    chip_smoke.probe_rate(torch, gen, "stream_ref", 16384, 65536)  # sound; 512 MB of words
    faulty = _planted(tmp_path, "stream_probe.cu", *PROBE_FAULT, "stream_probe")
    monkeypatch.setitem(build.TOOL_KERNELS, "stream_probe", faulty)
    with pytest.raises(AssertionError, match="K13") as caught:
        chip_smoke.probe_rate(torch, gen, "stream_ref", 16384, 65536)
    print(caught.value)


def test_kernel_sources_hold_the_planted_lines():
    """The lines the card's fault tests plant faults in are in the sources
    once each, each fault's case takes the path it names at its rows of x,
    where a block sum is never cleared a warp of the case takes several blocks
    of its split, and K10's cases run more than one split (132 SMs)."""
    for fault, (name, source, written, _, (kern, _, k, n), path, ms) in FAULTS.items():
        assert (build.CSRC_DIR / source).read_text().count(written) == 1, (source, written)
        assert build.TOOL_KERNELS[name].source.name == source
        assert chip_smoke.LAB_KERNEL[kern] == name
        for m in ms:
            with _on_path(kern, path, m):
                assert kern in ("K10", "K13") or lab_kernels.lab_path(m, n) == path, (fault, m)
        if kern == "K10":
            gn = -(-n // 1024)
            assert lab_kernels.k10_plan(max(ms), k, gn, 132)[0] > 1, fault  # several splits
        if "block sum" in fault:
            which = "q4" if kern == "K11" else "colnibble"
            _, per = lab_kernels._lab_splits(which, "tc", 8, k, n, 132)
            # K11: every warp walks each block of its split; K12: the 4 warps interleave
            assert per >= (2 if kern == "K11" else 5), (fault, per)
    assert (build.CSRC_DIR / "stream_probe.cu").read_text().count(PROBE_FAULT[0]) == 1
