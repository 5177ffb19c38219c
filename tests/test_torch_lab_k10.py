"""K10 (fastmax_tpu_torch/csrc/int4_tiled_bf16.cu) and K13's plans
(csrc/stream_probe.cu), on the CPU.

The kernels run only on the card (tests/test_torch_tools.py's ``cuda`` tests
hold them against their plain versions there, with planted faults). Here: the
wrappers' copies of the sources' constants, the split plans they pass to the C
entries, and an emulation of K10's sums in its order (each warp's 16-row
steps, one mma a step, summed in f32; the 4 warps in warp order; the k splits
in split order, by the last block of a unit to finish) against the JAX scripts' ``bf16_matmul`` and
``m8_matmul(dtype=bf16)`` in interpret mode, under chip_smoke.py's phase 11
gate, with the faults the card's tests plant breaking it. Inputs follow phase
11's law (x ~ N(0.5, 1), codes uniform), made with numpy from a seed.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

import chip_smoke
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import quant
from fastmax_tpu_torch.tools import lab_kernels as lk
from tools import int4_opt_r04 as j04
from tools import int4_opt_r05 as j05

SM_COUNT = 132  # the H100's
K10_SOURCE = build.CSRC_DIR / "int4_tiled_bf16.cu"
K13_SOURCE = build.CSRC_DIR / "stream_probe.cu"
K10_WARPS = int(re.findall(r"constexpr int kWarps = (\d+);", K10_SOURCE.read_text())[0])


class _Interpret:
    """``pallas`` with every ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(jpl, name)

    @staticmethod
    def pallas_call(*args, **kw):
        return jpl.pallas_call(*args, **{**kw, "interpret": True})


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    for mod in (j04, j05):
        monkeypatch.setattr(mod, "pl", _Interpret())


def _constant(source, name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", source.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_wrappers_mirror_the_kernel_constants():
    """lab_kernels' copies of the sources' constants are the sources': K10's
    units of a 1024-column tile (128 lanes over the lanes a block takes), its
    split granule (one 16-row step a warp), split limit and blocks an SM;
    K13's column threads, split limit and blocks an SM."""
    assert lk.K10_SLICES == 128 // _constant(K10_SOURCE, "kUnitLanes")
    assert lk.K10_SPLIT_ROWS == K10_WARPS * _constant(K10_SOURCE, "kStep")
    assert lk.K10_MAX_SPLITS == _constant(K10_SOURCE, "kMaxSplits")
    assert lk.K10_BLOCKS_PER_SM == _constant(K10_SOURCE, "kBlocksPerSm")
    assert lk.PROBE_COL_THREADS == _constant(K13_SOURCE, "kColThreads")
    assert lk.PROBE_MAX_SPLITS == _constant(K13_SOURCE, "kMaxSplits")
    assert lk.PROBE_BLOCKS_PER_SM == _constant(K13_SOURCE, "kBlocksPerSm")


@pytest.mark.parametrize("m", [1, 5, 8, 16, 64])
@pytest.mark.parametrize("k,gn", [(4096, 12), (4096, 4), (4096, 22), (11008 + 256, 4),
                                  (1040, 2), (16, 1)])
def test_k10_plan_covers_k_in_whole_rounds(k, gn, m):
    """At most 8 splits, each whole 64-row rounds (a
    16-row step a warp) and none empty, covering k; the busiest SM streams
    within an eighth of a perfect spread, plus one block, where k has the rounds
    for it; at the 7B linears for m <= 8 one wave. qkv: 8 splits of 512 rows
    (768 blocks); attn.proj: 8 of 512; fc_12: 3 of 1408 (the last partial);
    mlp.proj (k_pad 11264): 8 of 1408."""
    splits, rows = lk.k10_plan(m, k, gn, SM_COUNT)
    assert 1 <= splits <= lk.K10_MAX_SPLITS and rows % lk.K10_SPLIT_ROWS == 0
    assert (splits - 1) * rows < k <= splits * rows
    units = gn * lk.K10_SLICES * math.ceil(m / 8)
    rounds = math.ceil(k / lk.K10_SPLIT_ROWS)
    per = rows // lk.K10_SPLIT_ROWS
    if rounds >= 64:
        assert math.ceil(units * splits / SM_COUNT) * per <= 1.125 * units * rounds / SM_COUNT + per
    want = {(4096, 12): (8, 512), (4096, 4): (8, 512), (4096, 22): (3, 1408),
            (11264, 4): (8, 1408)}
    if m <= 8 and (k, gn) in want:
        assert (splits, rows) == want[(k, gn)]
        assert units * splits <= lk.K10_BLOCKS_PER_SM * SM_COUNT


class _Launches:
    """Stands in for a kernel's binding: records the C entry's arguments."""

    def __init__(self):
        self.args = []

    def launch(self, *args):
        self.args.append(args)


@pytest.mark.parametrize("m", [1, 5, 8])
def test_k10_wrapper_launches_once_with_its_plan(m, monkeypatch):
    """One launch a call (no reduce kernel), with k10_plan's splits and rows, a
    slot of part for each block and the kept counters, and y of (m, gn*1024)."""
    launches = _Launches()
    monkeypatch.setitem(lk.TOOL_KERNELS, "int4_tiled_bf16", launches)
    monkeypatch.setattr(lk, "_sm_count", lambda index: SM_COUNT)
    monkeypatch.setattr(lk, "use_kernel", lambda *a, plain=False: True)
    y = lk.int4_tiled_bf16(torch.zeros((m, 4096)), torch.zeros((1, 3, 4096, 128),
                                                                dtype=torch.int32))
    assert y.shape == (m, 3072)
    (args,) = launches.args
    assert len(args) == 11 and args[1] == m and args[3:6] == (1, 3, 4096)
    assert args[-2:] == lk.k10_plan(m, 4096, 3, SM_COUNT)


@pytest.mark.parametrize("n,tiles", [(12288, 8), (4096, 8), (22016, 8), (4096, 21), (3004, 3),
                                     (256, 1)])
def test_probe_plan_splits_the_tiles(n, tiles):
    """stream_bytes' plan: strips of 128 columns (32 where n % 16 != 0), at
    most 8 splits of the tiles, none empty, together covering them."""
    splits, per, strips = lk.probe_plan(n, tiles, SM_COUNT)
    assert strips == math.ceil(n / (128 if n % 16 == 0 else 32))
    assert 1 <= splits <= lk.PROBE_MAX_SPLITS and (splits - 1) * per < tiles <= splits * per


def test_probe_wrappers_launch_once(monkeypatch):
    """Each probe is one launch with a checksum word for each block, which the
    kernel writes (no buffer zeroed for the call, no second kernel)."""
    launches = _Launches()
    monkeypatch.setitem(lk.TOOL_KERNELS, "stream_probe", launches)
    monkeypatch.setattr(lk, "_sm_count", lambda index: SM_COUNT)
    monkeypatch.setattr(lk, "use_kernel", lambda *a, plain=False: True)
    out = lk.stream_tiled(torch.zeros((1, 2, 512, 128), dtype=torch.int32))
    assert out.shape == (1, 2048)
    out = lk.stream_bytes(torch.zeros((2048, 4096), dtype=torch.uint8),
                          torch.zeros((64, 4096)), 512, 256)
    assert out.shape == (1, 4096)
    (a0, a1) = launches.args
    assert a0[0] == 0 and a0[8] == 2 * SM_COUNT
    splits, per, strips = lk.probe_plan(4096, 8, SM_COUNT)
    assert a1[0] == 1 and a1[8:10] == (splits, per)


# ------------------------------------------------------------------ K10's sums


def _k10_case(k, n, m, seed=0, tile_k=None):
    rng = np.random.default_rng(seed)
    pw = quant.pack_int4_tiled(rng.integers(-8, 8, (k, n)), tile_k)
    x = (rng.standard_normal((m, pw.shape[0] * pw.shape[2])) + 0.5).astype(np.float32)
    return x, pw


def _k10_sum(x, pw, kind="sound", sm_count=SM_COUNT):
    """K10's sums, emulated: split s of k10_plan takes its 16-row steps in turn,
    warp w steps w, w + 4, ...; a step's 16 products are summed
    exactly (one mma) and rounded once into the warp's f32 sum; the warps' sums
    are added in warp order, the splits' in split order. ``kind`` plants the
    faults the card's tests plant: "planes swapped" (output planes 2i and 2i + 1
    exchanged), "split left out" (the first split's sums missing from the
    split-order sum), "rows past m" (rows of x past m, zero, written into the
    compact sums unmasked: at 4 <= r < 8 rows of the last chunk, rows r..7 of
    block column c land on rows 0..7-r of column c + 1, and after its own rows
    where c + 1 is even and not a multiple of 16, the next thread's first
    columns of a plane)."""
    xt, wt = torch.from_numpy(x), torch.from_numpy(pw)
    gk, gn, tk, _ = wt.shape
    m, k = xt.shape
    xb = xt.to(torch.bfloat16).double()
    q = quant._unpack_int4_tiled(wt).double()
    steps = torch.bmm(xb.reshape(m, k // 16, 16).transpose(0, 1), q.reshape(k // 16, 16, -1))
    splits, rows = lk.k10_plan(m, k, gn, sm_count)
    y = torch.zeros((m, gn * 1024), dtype=torch.float32)
    for s in range(splits):
        k0, k1 = s * rows, min((s + 1) * rows, k)
        warps = [torch.zeros_like(y) for _ in range(K10_WARPS)]
        for st in range(k0 // 16, k1 // 16):
            w = (st - k0 // 16) % K10_WARPS
            warps[w] = (warps[w].double() + steps[st]).float()
        part = warps[0]
        for w in warps[1:]:
            part = part + w
        if kind == "rows past m" and 4 <= m % 8:
            r = m % 8
            cols = [gi * 1024 + p * 128 + l0 + l for gi in range(gn) for l0 in range(0, 128, 16)
                    for p in range(8) for l in range(2, 16, 2)]
            part[m - r:m - r + 8 - r, cols] = 0.0
        if kind == "split left out" and s == 0:
            continue
        y = y + part
    if kind == "planes swapped":
        y = y.reshape(m, gn, 8, 128)[:, :, [1, 0, 3, 2, 5, 4, 7, 6]].reshape(m, -1)
    return y


def _over_gate(got, ref) -> float:
    ref = torch.from_numpy(np.array(ref, np.float32))
    tol = chip_smoke.LAB_ATOL * float(ref.abs().max()) + chip_smoke.LAB_RTOL * ref.abs()
    return float(((got - ref).abs() > tol).float().mean())


@pytest.mark.parametrize("m,k,n", [(1, 1024, 2048), (8, 1024, 2048), (8, 1536, 3072)])
def test_k10_sum_holds_the_gate_against_bf16_matmul(m, k, n):
    """The emulated sums meet phase 11's gate against the JAX bf16_matmul
    (tools/int4_opt_r05.py:158, interpret mode), within a tenth of its atol; at
    k = 1536, n = 3072 the last of 5 splits of 320 rows is partial."""
    x, pw = _k10_case(k, n, m)
    splits, rows = lk.k10_plan(m, k, n // 1024, SM_COUNT)
    assert splits > 1 and (k != 1536 or (splits, rows) == (5, 320))
    ref = np.asarray(j05.bf16_matmul(jnp.asarray(x), jnp.asarray(pw)))
    got = _k10_sum(x, pw)
    assert _over_gate(got, ref) == 0.0
    assert float((got - torch.from_numpy(ref)).abs().max()) < 0.1 * chip_smoke.LAB_ATOL * float(
        np.abs(ref).max())


def test_k10_sum_holds_the_gate_against_m8_matmul():
    """The same against the JAX m8_matmul(dtype=bf16) (tools/int4_opt_r04.py:145)
    with words of two k tiles (tile_k = 512: gk = 2)."""
    x, pw = _k10_case(1024, 1024, 8, seed=3, tile_k=512)
    assert pw.shape[0] == 2
    ref = np.asarray(j04.m8_matmul(jnp.asarray(x), jnp.asarray(pw), dtype=jnp.bfloat16))
    assert _over_gate(_k10_sum(x, pw), ref) == 0.0


@pytest.mark.parametrize("m", [5, 13])
def test_k10_sum_holds_the_gate_against_plain(m):
    """At rows of x that leave the last chunk short (what the mask of rows past
    m guards), the emulated sums meet the gate against int4_tiled_bf16_plain."""
    x, pw = _k10_case(1024, 1024, m, seed=2)
    ref = lk.int4_tiled_bf16_plain(torch.from_numpy(x), torch.from_numpy(pw))
    assert _over_gate(_k10_sum(x, pw), ref.numpy()) == 0.0


@pytest.mark.parametrize("fault,m,share", [("planes swapped", 1, 0.5), ("planes swapped", 8, 0.5),
                                           ("split left out", 8, 0.5), ("rows past m", 5, 0.1)])
def test_k10_faults_break_the_gate(fault, m, share):
    """The faults the card's tests plant (tests/test_torch_tools.py FAULTS) put
    at least ``share`` of the emulated outputs over phase 11's gate: planes
    exchanged, one split's sums left out of the split-order sum, and, at m = 5,
    rows of x past m written unmasked into the compact sums."""
    x, pw = _k10_case(1024, 2048, m, seed=1)
    ref = lk.int4_tiled_bf16_plain(torch.from_numpy(x), torch.from_numpy(pw)).numpy()
    assert _over_gate(_k10_sum(x, pw), ref) == 0.0
    assert _over_gate(_k10_sum(x, pw, fault), ref) > share
