"""The route and the arithmetic of K8's tensor-core path (``nf4_tc_kernel`` in
fastmax_tpu_torch/csrc/nf4_matmul.cu), on the CPU.

The kernel itself runs only on the card (tests/test_torch_quant_serving.py's
``cuda`` tests hold it against ``nf4_matmul_plain`` there, with planted faults).
Here: ``nf4_path`` and ``_nf4_splits`` as the wrapper passes them to the C entry;
the kernel's split of the code table into bf16 parts, mirrored in PyTorch; and
an emulation of its sums (the kept products, a fresh f32 sum for each 64-row
quant block scaled once by its absmax, the splits added in order) against
``nf4_matmul_plain``, which tests/test_torch_quant_serving.py holds against the
JAX kernel in interpret mode, under chip_smoke.py's f32 gate. Inputs follow
phase 10's law (weights N(0, 0.05), x N(0.5, 1)), made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fastmax_tpu_torch.ops import quant, quant_kernels

SM_COUNT = 132  # the H100's


def _parts(v: torch.Tensor, n: int) -> list:
    """``v`` (f32) as n parts, each the nearest bf16 of what the parts before it
    left (split3_bf16x2), as float64 tensors."""
    out, rest = [], v.float()
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).double())
        rest = rest - out[-1].float()
    return out


def _codes(packed: torch.Tensor) -> torch.Tensor:
    """The (k, n) code indices of a (k/2, n) packed array: high nibble row 2r."""
    q = packed.long()
    return torch.stack([q >> 4, q & 0xF], 1).reshape(-1, packed.shape[1])


def _tc_sum(x, p, kind="tc", xdt=torch.float32, plan_n=None):
    """K8's tensor-core sum, emulated. B holds x in one bf16 part (bf16 x) or
    two (f32 x: x0, x1); A each of the code's three bf16 parts. The kernel's
    products: x with every code part, and for f32 x also x1 c0. Each 16-row
    step's product goes into the quant block's f32 sum as one mma adds it (its
    16 products summed exactly, one rounding: to nearest here, the card's adder
    truncates); each block's sum goes into its split's running sum times the
    block's absmax with one rounding (fmaf); the splits' sums are added in
    order. ``kind`` plants the faults the card's tests plant: "first part"
    (code part c0 alone), "high x" (f32 x0 alone), "no reset" (a block's sum
    carried into the next block of its split). The splits are those of an
    n-column call, or of a ``plan_n``-column one."""
    m, k = x.shape
    n = p["q4"].shape[1]
    nb = k // quant.DEFAULT_BLOCK
    cparts = _parts(p["code"], 3)
    codes = _codes(p["q4"])
    w = [c[codes] for c in cparts]
    xs = _parts(x, 2 if xdt == torch.float32 else 1)
    prods = [(0, c) for c in range(3)] + ([(1, 0)] if len(xs) == 2 else [])
    if kind == "first part":
        prods = [(i, c) for i, c in prods if c == 0]
    if kind == "high x":
        prods = [(i, c) for i, c in prods if i == 0]
    am = quant._absmax_of(p, k, n).double()
    splits, bps = quant_kernels._nf4_splits(m, nb, plan_n or n, SM_COUNT, "tc")
    y = torch.zeros((m, n), dtype=torch.float32)
    for s in range(splits):
        acc = torch.zeros_like(y)
        blk = torch.zeros_like(y)
        for b in range(s * bps, min((s + 1) * bps, nb)):
            if kind != "no reset":
                blk = torch.zeros_like(y)
            for r in range(b * quant.DEFAULT_BLOCK, (b + 1) * quant.DEFAULT_BLOCK, 16):
                for i, c in prods:
                    blk = (blk.double() + xs[i][:, r:r + 16] @ w[c][r:r + 16]).float()
            acc = (blk.double() * am[b] + acc.double()).float()
        y = y + acc
    return y


def _case(k, n, m, kind="nf4", seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32))
    p = quant.quantize_4bit(w, kind)
    x = torch.from_numpy((rng.standard_normal((m, k)) + 0.5).astype(np.float32))
    return x, p


def _over_gate(got, ref, rtol):
    """The share of outputs outside chip_smoke.py's K8 gate (NF4_ATOL + rtol |ref|)."""
    return float(((got - ref).abs() > chip_smoke.NF4_ATOL + rtol * ref.abs()).float().mean())


# ------------------------------------------------------------------ the route


def test_nf4_path_covers_every_m():
    """The gemv up to 4 rows, the tensor cores up to 64, the 64-row FMA tile
    above; on the route before the tensor cores (chip_smoke.earlier_route:
    NF4_GEMV_MAX_M at 8) the gemv takes m <= 8 again and the tensor cores none."""
    want = {m: "gemv" if m <= 4 else "tc" if m <= 64 else "fma" for m in range(1, 130)}
    assert {m: quant_kernels.nf4_path(m) for m in range(1, 130)} == want
    with chip_smoke.earlier_route(quant_kernels, "K8"):
        assert {m: quant_kernels.nf4_path(m) for m in range(1, 130)} == {
            m: "gemv" if m <= 8 else "fma" for m in range(1, 130)}
    assert quant_kernels.nf4_path(8) == "tc"


class _Launches:
    """Stands in for a kernel's binding: records the C entry's arguments."""

    def __init__(self):
        self.args = []

    def launch(self, *args):
        self.args.append(args)


@pytest.mark.parametrize("m", [5, 8, 64])
@pytest.mark.parametrize("k,n", [(1088, 3000), (4096, 4096), (11008, 4096)])
def test_nf4_launch_splits_on_quant_blocks(k, n, m, monkeypatch):
    """The wrapper passes the tensor-core path (the C entry's last int: 1) with
    a split plan in whole 64-row quant blocks that covers each block once, and
    launches at least three blocks of 256 columns by 8 rows for each of 132 SMs
    where k allows (four fit on one);
    at k = 11008 and m = 8 a warp takes several quant blocks of its split (what
    a block sum that is not reset needs to show)."""
    launches = _Launches()
    monkeypatch.setitem(quant_kernels.KERNELS, "nf4_matmul", launches)
    monkeypatch.setattr(quant_kernels, "_sm_count", lambda index: SM_COUNT)
    p = quant.quantize_4bit(torch.zeros((k, n)))
    y = quant_kernels._nf4_launch(torch.zeros((m, k)), p["q4"], p["absmax"], p["code"],
                                  torch.float32)
    assert y.shape == (m, n)
    (args,) = launches.args
    splits, bps, path = args[-3:]
    nb = k // quant.DEFAULT_BLOCK
    assert quant_kernels._NF4_PATHS[path] == "tc"
    blocks = [b for s in range(splits) for b in range(s * bps, min((s + 1) * bps, nb))]
    assert blocks == list(range(nb))  # each quant block once, each split starting on one
    assert (splits - 1) * bps < nb
    ctas = -(-m // 8) * -(-n // 256) * splits
    assert ctas >= min(3 * SM_COUNT, -(-m // 8) * -(-n // 256) * nb)
    assert (args[-4] is None) == (splits == 1)  # partials only with more than one split
    if (k, m) == (11008, 8):
        assert bps >= 2


@pytest.mark.parametrize("m,path", [(1, 0), (4, 0), (65, 2), (512, 2)])
def test_nf4_launch_keeps_the_other_paths(m, path, monkeypatch):
    """Outside 4 < m <= 64 the wrapper passes the gemv (0) or the FMA tile (2)."""
    launches = _Launches()
    monkeypatch.setitem(quant_kernels.KERNELS, "nf4_matmul", launches)
    monkeypatch.setattr(quant_kernels, "_sm_count", lambda index: SM_COUNT)
    p = quant.quantize_4bit(torch.zeros((4096, 4096)))
    quant_kernels._nf4_launch(torch.zeros((m, 4096)), p["q4"], p["absmax"], p["code"],
                              torch.float32)
    assert launches.args[0][-1] == path


# ------------------------------------------------------------------ the arithmetic


@pytest.mark.parametrize("kind", sorted(quant.CODEBOOKS))
def test_code_splits_into_three_bf16_parts(kind):
    """Every code splits exactly into three bf16 parts (what the kernel's byte
    table holds); NF4 and FP4 need all three, the int4 levels one."""
    code = torch.from_numpy(quant.CODEBOOKS[kind])
    exact = code.double()
    assert torch.equal(sum(_parts(code, 3)), exact)
    need = 1 if kind == "int4" else 3
    assert torch.equal(sum(_parts(code, need)), exact)
    if need == 3:
        two = sum(_parts(code, 2))
        assert not torch.equal(two, exact)
        assert float(((two - exact).abs() / exact.abs().clamp_min(1e-30)).max()) < 2 ** -16


@pytest.mark.parametrize("kind", ["nf4", "fp4"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_tc_sum_holds_the_gate(kind, xdt):
    """The emulated tensor-core sum at k = 4096, n = 512, m = 8 meets phase 10's
    gate against nf4_matmul_plain: f32 x (four products a tile) at NF4_ATOL +
    NF4_RTOL |ref|, bf16 x (three) at NF4_ATOL + INT4_BF16_RTOL |ref|, and for
    both types within a fifth of the f32 gate."""
    x, p = _case(4096, 512, 8, kind)
    x = x.to(xdt).float()
    ref = quant_kernels.nf4_matmul_plain(x, p["q4"], p["absmax"], p["code"])
    got = _tc_sum(x, p, xdt=xdt)
    rtol = chip_smoke.NF4_RTOL if xdt == torch.float32 else chip_smoke.INT4_BF16_RTOL
    assert _over_gate(got, ref, rtol) == 0.0
    err = (got - ref).abs() / (chip_smoke.NF4_ATOL + chip_smoke.NF4_RTOL * ref.abs())
    assert float(err.max()) < 0.3


@pytest.mark.parametrize("fault,k", [("first part", 4096), ("high x", 4096),
                                     ("no reset", 11008)])
def test_tc_faults_break_the_gate(fault, k):
    """The faults the card's tests plant in the kernel put the emulated sum
    over the f32 gate: code part c0 alone, f32 x's high part alone, and a block
    sum carried into the next block of a split (seen where a warp takes several
    blocks: k = 11008 at m = 8). 256 of the n = 4096 columns the card's tests
    use, with their split plan."""
    x, p = _case(k, 256, 8)
    ref = quant_kernels.nf4_matmul_plain(x, p["q4"], p["absmax"], p["code"])
    got = _tc_sum(x, p, fault, plan_n=4096)  # the splits of the card's case, n = 4096
    assert _over_gate(got, ref, chip_smoke.NF4_RTOL) > 0.1
