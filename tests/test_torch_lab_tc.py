"""The route and the arithmetic of the lab kernels' tensor-core paths, on the CPU:
K11's ``q4_byte_tc_kernel`` (fastmax_tpu_torch/csrc/q4_byte_matmul.cu) and
K12's ``colnibble_tc_kernel`` (csrc/int4_colnibble_matmul.cu).

The kernels run only on the card (tests/test_torch_tools.py's ``cuda`` tests
hold them against their plain versions there, with planted faults). Here:
``lab_path`` and the split plans as the wrappers pass them to the C entries;
the split of the value tables into bf16 parts and v8's XOR before the
two's-complement decode, mirrored in PyTorch; and an emulation of both
kernels' sums against ``q4_byte_matmul_plain`` and ``colnibble_matmul_plain``
(which tests/test_torch_tools.py holds against the JAX scripts in interpret
mode) under chip_smoke.py's phase 11 gate, with the faults the card's tests
plant breaking it. Inputs follow phase 11's law (x ~ N(0.5, 1), absmax
0.01-0.03, codes uniform), made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fastmax_tpu_torch.ops import quant
from fastmax_tpu_torch.tools import lab_kernels as lk
from fastmax_tpu_torch.tools import nf4_variants_r04 as tv

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
SM_COUNT = 132  # the H100's
NF4 = torch.tensor(quant.NF4_CODE, dtype=torch.float32)
INT4 = torch.tensor(tv._INT4_LEVELS, dtype=torch.float32)
# K11's modes as nf4_variants_r04 calls K11: (table, scale_mul, per_block, bf16 operands)
K11_MODES = {"v1": (NF4, 1.0, False, False), "v2": (NF4, 1.0, False, False),
             "v5": (NF4.to(torch.bfloat16).float(), 1.0, True, True),
             "v6": (INT4, 0.125, False, True), "v7": (INT4, 0.125, True, True)}


def _parts(v: torch.Tensor, n: int) -> list:
    """``v`` (f32) as n parts, each the nearest bf16 of what the parts before it
    left (split3_bf16x2), as float64 tensors."""
    out, rest = [], v.float()
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).double())
        rest = rest - out[-1].float()
    return out


def _steps(xp: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """(k/16, m, n): each 16-row step's product of x (m, k) and w (k, n), its 16
    products summed exactly (one mma; rounded once when added)."""
    m, k = xp.shape
    return torch.bmm(xp.reshape(m, k // 16, 16).transpose(0, 1), wp.reshape(k // 16, 16, -1))


def _over_gate(got, ref) -> float:
    """The share of outputs outside phase 11's gate (LAB_ATOL of the largest |ref|
    + LAB_RTOL |ref|)."""
    tol = chip_smoke.LAB_ATOL * float(ref.abs().max()) + chip_smoke.LAB_RTOL * ref.abs()
    return float(((got - ref).abs() > tol).float().mean())


def _k11_case(k, n, m, variant, seed=0):
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n)).astype(np.uint8))
    absmax = torch.from_numpy(rng.uniform(0.01, 0.03, (k // 64, n)).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((m, k)) + 0.5).astype(np.float32))
    if K11_MODES[variant][3]:
        x = x.to(torch.bfloat16).float()
    return x, packed, absmax


def _k11_tc_sum(x, packed, absmax, variant, kind="tc", plan_n=None):
    """K11's tensor-core sum, emulated. bf16 operands (v5-v7): one part of x and
    of the table, one product a tile; f32 (v1, v2): the table's three parts, x's
    two, and the products x0 c0, x0 c1, x0 c2, x1 c0. Each 16-row step's product
    goes into the 64-row block's f32 sum; each block's sum into its split's
    running sum times absmax * scale_mul with one rounding (fmaf), for both of
    the reference's orders; the splits are added in order. ``kind`` plants the
    faults the card's tests plant: "first part" (code part c0 alone), "high x"
    (x0 alone), "no reset" (a block's sum carried into the next block of its
    split). The splits are those of an n-column call, or of a ``plan_n``-column one."""
    table, mul, _, bf16 = K11_MODES[variant]
    m, k = x.shape
    n = packed.shape[1]
    nb = k // 64
    codes = lk._q4_values(packed, torch.arange(16, dtype=torch.float32)).long()
    w = [c[codes] for c in _parts(table, 1 if bf16 else 3)]
    xs = _parts(x, 1 if bf16 else 2)
    prods = [(0, 0)] if bf16 else [(0, 0), (0, 1), (0, 2), (1, 0)]
    if kind == "first part":
        prods = [(i, c) for i, c in prods if c == 0]
    if kind == "high x":
        prods = [(i, c) for i, c in prods if i == 0]
    step = {(i, c): _steps(xs[i], w[c]) for i, c in prods}
    s = (absmax * mul).double()
    splits, per = lk._lab_splits("q4", "tc", m, k, plan_n or n, SM_COUNT)
    y = torch.zeros((m, n), dtype=torch.float32)
    for sp in range(splits):
        acc = torch.zeros_like(y)
        blk = torch.zeros_like(y)
        for b in range(sp * per, min((sp + 1) * per, nb)):
            if kind != "no reset" or b == sp * per:
                blk = torch.zeros_like(y)
            for st in range(4 * b, 4 * b + 4):
                for pc in prods:
                    blk = (blk.double() + step[pc][st]).float()
            acc = (blk.double() * s[b] + acc.double()).float()
        y = y + acc
    return y


def _k12_case(k, n, m, variant, seed=0):
    rng = np.random.default_rng(seed)
    pw = torch.from_numpy(rng.integers(0, 2**32, (k, n // 8), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32))
    s = torch.from_numpy(rng.uniform(0.01, 0.03, (k // 64, n)).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((m, k)) + 0.5).astype(np.float32))
    if variant in ("v10", "v11"):
        x = x.to(torch.bfloat16).float()
    return x, pw, s


def _k12_tc_sum(x, pw, s, variant, kind="tc", plan_n=None):
    """K12's tensor-core sum, emulated, in real column order. v8, v9: x in three
    bf16 parts, three products a plane; v10, v11: x one part. v8's words are
    XORed with 0x88888888 before the two's-complement decode. Each warp of a
    split takes the split's 64-row blocks b0 + w, b0 + w + 4, ...: v8, v9, v11
    sum a block in a fresh f32 sum and add it times s * 0.125 with one
    rounding; v10 multiplies x by bf16(q * bf16(s * 0.125)) and adds each step
    to its running sum. The warps' sums are added in warp order, the splits in
    split order. ``kind``: "high x" (x0 alone), "no xor" (v8 decoded as v9),
    "scale out" (v10 as v11: the f32 scale on the block sum), "no reset" (a
    warp's block sum carried into its next block)."""
    m, k = x.shape
    n = pw.shape[1] * 8
    nb = k // 64
    q = lk._colnibble_codes(pw, variant == "v8" and kind != "no xor")
    s8 = s * 0.125
    in_a = variant == "v10" and kind != "scale out"
    if in_a:
        sb = s8.to(torch.bfloat16).repeat_interleave(64, 0)
        q = (q.to(torch.bfloat16) * sb).float()
    xs = _parts(x, 3 if variant in ("v8", "v9") else 1)
    if kind == "high x":
        xs = xs[:1]
    step = [_steps(xp, q.double()) for xp in xs]
    splits, per = lk._lab_splits("colnibble", "tc", m, k, plan_n or n, SM_COUNT)
    y = torch.zeros((m, n), dtype=torch.float32)
    for sp in range(splits):
        b0, b1 = sp * per, min((sp + 1) * per, nb)
        total = torch.zeros_like(y)
        for warp in range(4):
            acc = torch.zeros_like(y)
            blk = torch.zeros_like(y)
            for b in range(b0 + warp, b1, 4):
                if kind != "no reset" or b == b0 + warp:
                    blk = torch.zeros_like(y)
                for st in range(4 * b, 4 * b + 4):
                    for part in step:
                        if in_a:
                            acc = (acc.double() + part[st]).float()
                        else:
                            blk = (blk.double() + part[st]).float()
                if not in_a:
                    acc = (blk.double() * s8[b].double() + acc.double()).float()
            total = total + acc
        y = y + total
    return y


# ------------------------------------------------------------------ the route


def test_lab_path_covers_every_m():
    """The gemv up to 4 rows and above 64, the tensor cores between where n %
    8 == 0 (K11's 8-byte loads), the gemv at any n % 8 != 0; on the earlier
    route (chip_smoke.earlier_route) the gemv at every m, for both kernels."""
    for n in (4096, 3000, 3004, 1028):
        want = {m: "tc" if 4 < m <= 64 and n % 8 == 0 else "gemv" for m in range(1, 130)}
        assert {m: lk.lab_path(m, n) for m in range(1, 130)} == want
        for kern in ("K11", "K12"):
            with chip_smoke.earlier_route(lk, kern):
                assert {lk.lab_path(m, n) for m in range(1, 130)} == {"gemv"}
    assert lk.lab_path(8, 4096) == "tc"
    with pytest.raises(ValueError):
        with chip_smoke.earlier_route(lk, "K10"):
            pass


class _Launches:
    """Stands in for a kernel's binding: records the C entry's arguments."""

    def __init__(self):
        self.args = []

    def launch(self, *args):
        self.args.append(args)


@pytest.mark.parametrize("m", [5, 8, 64])
@pytest.mark.parametrize("k", [1088, 4096, 11008])
@pytest.mark.parametrize("kern", ["K11", "K12"])
def test_lab_launch_splits_on_64_row_blocks(kern, k, m, monkeypatch):
    """The wrappers pass the tensor-core path (the C entry's last int: 1) with a
    split plan in whole 64-row blocks that covers each block once, and launch
    at least three blocks (8 rows by 256 columns for K11, by one 128-column
    unit for K12) for each of 132 SMs where k allows; at k = 11008 and m = 8
    each K11 warp walks several blocks of its split, and a K12 warp (the 4
    interleave) at least two: what a block sum that is not cleared needs to show."""
    n = 4096
    launches = _Launches()
    monkeypatch.setattr(lk, "_sm_count", lambda index: SM_COUNT)
    x = torch.zeros((m, k))
    if kern == "K11":
        monkeypatch.setitem(lk.TOOL_KERNELS, "q4_byte_matmul", launches)
        y = lk._q4_launch(x, torch.zeros((k // 2, n), dtype=torch.uint8),
                          torch.zeros((k // 64, n)), torch.zeros(16), 1.0, False, True)
        cols = 256
    else:
        monkeypatch.setitem(lk.TOOL_KERNELS, "int4_colnibble_matmul", launches)
        y = lk._colnibble_launch(x, torch.zeros((k, n // 8), dtype=torch.int32),
                                 torch.zeros((k // 64, n)), "v8")
        cols = 128
    assert y.shape == (m, n)
    (args,) = launches.args
    path = args[-1]
    splits, per = args[-4:-2] if kern == "K11" else args[-3:-1]  # K11: then bf16 operands
    nb = k // 64
    assert lk._LAB_PATHS[path] == "tc"
    blocks = [b for s in range(splits) for b in range(s * per, min((s + 1) * per, nb))]
    assert blocks == list(range(nb))  # each 64-row block once, each split starting on one
    assert (splits - 1) * per < nb
    units = -(-m // 8) * (n // cols)
    assert units * splits >= min(3 * SM_COUNT, units * nb)
    if (k, m) == (11008, 8):
        assert per >= (2 if kern == "K11" else 5)
    if kern == "K11":
        assert args[-2] == 1  # bf16 operands, as the caller said


@pytest.mark.parametrize("m,n", [(1, 4096), (4, 4096), (65, 4096), (8, 3004)])
def test_lab_launch_keeps_the_gemv(m, n, monkeypatch):
    """Outside 4 < m <= 64, and where n % 8 != 0, K11's wrapper passes the gemv (0)."""
    launches = _Launches()
    monkeypatch.setitem(lk.TOOL_KERNELS, "q4_byte_matmul", launches)
    monkeypatch.setattr(lk, "_sm_count", lambda index: SM_COUNT)
    lk._q4_launch(torch.zeros((m, 1024)), torch.zeros((512, n), dtype=torch.uint8),
                  torch.zeros((16, n)), torch.zeros(16), 1.0, False, False)
    assert launches.args[0][-1] == 0


# ------------------------------------------------------------------ the arithmetic


def test_value_tables_split_into_bf16_parts():
    """The f32 NF4 table (v1, v2) splits exactly into three bf16 parts and not
    two; the NF4 table rounded to bf16 (v5) and the c - 8 levels (v6, v7) are
    exact in one: what K11's byte table holds."""
    exact = NF4.double()
    assert torch.equal(sum(_parts(NF4, 3)), exact)
    assert not torch.equal(sum(_parts(NF4, 2)), exact)
    for table in (NF4.to(torch.bfloat16).float(), INT4):
        assert torch.equal(_parts(table, 1)[0], table.double())
    assert torch.equal(torch.tensor(tv._INT4_LEVELS), torch.arange(-8, 8).float())


def _nibble_bytes(w: torch.Tensor, p: int) -> torch.Tensor:
    """The kernel's decode of plane p: nibble_bytes (w ^ 0x88888888, nibble by
    nibble) gives c + 8 for the two's-complement code c; code_pair_bf16x2 that
    minus 8."""
    return (((w ^ -0x77777778) >> (4 * p)) & 0xF) - 8  # 0x88888888 as an int32


def test_xor_then_twos_complement_is_the_unsigned_decode():
    """For all 16 nibbles in all 8 planes, XOR 8 followed by the two's-complement
    decode gives (c & 0xF) - 8 (v8's code), and the kernel's decode of the
    words as they are gives the two's-complement nibble (v9's): both as the
    plain version decodes them."""
    c = np.arange(16, dtype=np.uint32)
    words = np.zeros((16, 128), np.uint32)
    for p in range(8):  # row r, lane l: nibble p holds (r + l + p) % 16, all 16 in each plane
        words |= ((c[:, None] + np.arange(128)[None, :] + p) % 16).astype(np.uint32) << (4 * p)
    pw = torch.from_numpy(words.view(np.int32))
    for p in range(8):
        raw = (pw >> (4 * p)) & 0xF
        assert set(raw.flatten().tolist()) == set(range(16))
        twos = lambda v: v - ((v >> 3) << 4)  # noqa: E731
        assert torch.equal(twos(((pw ^ -0x77777778) >> (4 * p)) & 0xF), raw - 8)
        assert torch.equal(_nibble_bytes(pw ^ -0x77777778, p), raw - 8)
        assert torch.equal(_nibble_bytes(pw, p), twos(raw))
        v8 = lk._colnibble_codes(pw, True).reshape(16, 8, 128)[:, p, :]
        v9 = lk._colnibble_codes(pw, False).reshape(16, 8, 128)[:, p, :]
        assert torch.equal(v8, (raw - 8).float()) and torch.equal(v9, twos(raw).float())


@pytest.mark.parametrize("m", [5, 8])
@pytest.mark.parametrize("variant", sorted(K11_MODES))
def test_k11_tc_sum_holds_the_gate(variant, m):
    """K11's emulated tensor-core sum at k = 4096, n = 256 meets phase 11's gate
    against q4_byte_matmul_plain in every mode: for v1, v2 and v6 with the scale
    out of the block's sum, and for v1, v2 with x1 c1, x2 c0 dropped; within a
    fifth of the gate's atol."""
    table, mul, per_block, _ = K11_MODES[variant]
    x, packed, absmax = _k11_case(4096, 256, m, variant)
    ref = lk.q4_byte_matmul_plain(x, packed, absmax, table, mul, per_block)
    got = _k11_tc_sum(x, packed, absmax, variant)
    assert _over_gate(got, ref) == 0.0
    assert float((got - ref).abs().max()) < 0.2 * chip_smoke.LAB_ATOL * float(ref.abs().max())


@pytest.mark.parametrize("m", [5, 8])
@pytest.mark.parametrize("variant", ["v8", "v9", "v10", "v11"])
def test_k12_tc_sum_holds_the_gate(variant, m):
    """K12's emulated tensor-core sum at k = 4096, n = 1024 (one column tile)
    meets phase 11's gate against colnibble_matmul_plain in every mode (v8, v9
    with the scale out of the block's sum; v10 with its per-weight rounding);
    within a fifth of the gate's atol."""
    x, pw, s = _k12_case(4096, 1024, m, variant)
    ref = lk.colnibble_matmul_plain(x, pw, s, variant)
    got = _k12_tc_sum(x, pw, s, variant)
    assert _over_gate(got, ref) == 0.0
    assert float((got - ref).abs().max()) < 0.2 * chip_smoke.LAB_ATOL * float(ref.abs().max())


@pytest.mark.parametrize("kern,variant,fault,k", [
    ("K11", "v1", "first part", 4096), ("K11", "v1", "high x", 4096),
    ("K11", "v7", "no reset", 11008), ("K12", "v8", "high x", 4096),
    ("K12", "v10", "scale out", 4096), ("K12", "v8", "no xor", 4096),
    ("K12", "v11", "no reset", 11008)])
def test_tc_faults_break_the_gate(kern, variant, fault, k):
    """The faults the card's tests plant (tests/test_torch_tools.py FAULTS) put
    the emulated sum over phase 11's gate: K11 with the codes' first bf16 part
    alone or x's high part alone (v1), K12 with x's high part alone (v8), v10's
    scale taken out of the product, v8 without the XOR, and, at k = 11008 where
    a warp takes several blocks of its split, a block sum never cleared (both).
    At m = 8, on the split plan of the card's case (n = 2048)."""
    if kern == "K11":
        table, mul, per_block, _ = K11_MODES[variant]
        x, packed, absmax = _k11_case(k, 256, 8, variant, seed=1)
        ref = lk.q4_byte_matmul_plain(x, packed, absmax, table, mul, per_block)
        got = _k11_tc_sum(x, packed, absmax, variant, fault, plan_n=2048)
    else:
        x, pw, s = _k12_case(k, 1024, 8, variant, seed=1)
        ref = lk.colnibble_matmul_plain(x, pw, s, variant)
        got = _k12_tc_sum(x, pw, s, variant, fault, plan_n=2048)
    assert _over_gate(got, ref) > 0.1
