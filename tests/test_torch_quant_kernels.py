"""The port's rank-1 int4 matmul (fastmax_tpu_torch/ops/quant_kernels.py)
against the Pallas kernels of fastmax_tpu/ops/quant_pallas.py, run in
interpret mode as the JAX package's own tests run them.

On the CPU the port's wrappers take the plain PyTorch version; the CUDA
kernel is compared with it by the ``cuda``-marked tests (skipped without a
card) and by chip_smoke.py. Tolerances: atol 2e-4, rtol 2e-3 against the
Pallas kernels (tests/test_quant_pallas.py); stacked vs per-layer 1e-5."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.ops import quant_pallas as jqp
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import quant, quant_kernels

# A fresh process's first exp after a matmul, on two threads, now and then gives other
# values than later calls; warming both up on one thread first avoids it.
torch.set_num_threads(1)
torch.exp(torch.ones(64, 64) @ torch.ones(64, 64))
torch.set_num_threads(2)
ATOL, RTOL = 2e-4, 2e-3


def _rank1(k, n, seed):
    kernel = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(np.float32)
    jp = jquant.quantize_int4_tiled(kernel, "rank1")
    return jp, {key: torch.from_numpy(np.array(v)) for key, v in jp.items()}


def _stack(k, n, n_layer, seed, tile_k=None):
    rng = np.random.default_rng(seed)
    layers = [{"q4r1": jqp.pack_int4_tiled(rng.integers(-8, 8, (k, n)), tile_k),
               "u4": rng.uniform(0.5, 2.0, (k,)).astype(np.float32),
               "v4": rng.uniform(0.5, 2.0, (n,)).astype(np.float32)} for _ in range(n_layer)]
    stacked = {key: np.stack([p[key] for p in layers]) for key in ("q4r1", "u4", "v4")}
    return ({key: jnp.asarray(v) for key, v in stacked.items()},
            {key: torch.from_numpy(v) for key, v in stacked.items()})


@pytest.mark.parametrize("k,n,tile_k", [(512, 1024, None), (192, 1100, None),
                                        (1024, 2048, 512)])
def test_pack_int4_tiled_byte_equal(k, n, tile_k):
    codes = np.random.default_rng(0).integers(-8, 8, (k, n))
    got = quant.pack_int4_tiled(codes, tile_k)
    ref = jqp.pack_int4_tiled(codes, tile_k)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("m", [1, 4, 64])
def test_int4_rank1_matches_pallas(m):
    jp, tp = _rank1(512, 1024, 1)
    x = np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32)
    ref = jqp.int4_matmul_rank1(jnp.asarray(x), jp, interpret=True)
    got = quant_kernels.int4_matmul_rank1(torch.from_numpy(x), tp)
    assert got.dtype == torch.float32 and got.shape == (m, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_int4_rank1_odd_shapes_padded():
    """k not a multiple of 512, n not a multiple of 1024, leading dims kept."""
    jp, tp = _rank1(192, 1100, 2)
    x = np.random.default_rng(2).standard_normal((1, 3, 192)).astype(np.float32)
    ref = jqp.int4_matmul_rank1(jnp.asarray(x), jp, interpret=True)
    got = quant_kernels.int4_matmul_rank1(torch.from_numpy(x), tp)
    assert got.shape == (1, 3, 1100)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_int4_rank1_stacked_every_layer(layer):
    jstack, tstack = _stack(512, 1024, 3, 3)
    x = np.random.default_rng(layer).standard_normal((2, 512)).astype(np.float32)
    ref = jqp.int4_matmul_rank1_stacked(jnp.asarray(x), jstack, jnp.int32(layer),
                                        interpret=True)
    got = quant_kernels.int4_matmul_rank1_stacked(torch.from_numpy(x), tstack, layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    per = quant_kernels.int4_matmul_rank1(
        torch.from_numpy(x), {key: v[layer] for key, v in tstack.items()})
    np.testing.assert_allclose(got.numpy(), per.numpy(), atol=1e-5, rtol=1e-5)


def test_int4_rank1_large_m_falls_back_to_dequant():
    """m above the per-layer cap (128) goes through dequantize + matmul."""
    jp, tp = _rank1(128, 1024, 4)
    x = np.random.default_rng(4).standard_normal((200, 128)).astype(np.float32)
    ref = jqp.int4_matmul_rank1(jnp.asarray(x), jp, interpret=True)
    got = quant_kernels.int4_matmul_rank1(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=RTOL)


def test_int4_rank1_stacked_large_m_falls_back_to_dequant():
    """m above the stacked cap (max(128, min(512, 28 MiB / (tk*4)))) too."""
    jstack, tstack = _stack(512, 1024, 2, 5)
    x = np.random.default_rng(5).standard_normal((600, 512)).astype(np.float32)
    ref = jqp.int4_matmul_rank1_stacked(jnp.asarray(x), jstack, jnp.int32(1), interpret=True)
    got = quant_kernels.int4_matmul_rank1_stacked(torch.from_numpy(x), tstack, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=RTOL)


@pytest.mark.parametrize("m", [1, 3, 5, 8, 16, 64, 512])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)])
def test_kernel_k_splits_cover_k(m, k, n):
    """The split-k plan for the CUDA kernels covers every row once, with no
    empty split, and keeps a 132-SM card busy: on the path K1 and K9 take
    (gemv for m <= 4, the tensor cores up to 64 rows) and on the FMA tile
    path, which both take above 64 rows."""
    gn = (n + 1023) // 1024
    k_pad = k + (-k) % 512
    path = quant_kernels.int4_path(m, k_pad)
    for kind in sorted({path, "gemv" if m <= quant_kernels.GEMV_MAX_M else "fma"}):
        splits, rows = quant_kernels._splits(m, k, gn, 132, kind)
        step = {"gemv": 128, "tc": 64, "fma": 32}[kind]
        assert splits >= 1 and rows % 32 == 0 and rows % step == 0
        assert (splits - 1) * rows < k <= splits * rows
        per_split = gn * {"gemv": 4, "tc": 8 * math.ceil(m / 8), "fma": 8 * math.ceil(m / 64)}[kind]
        assert per_split * splits >= 132 or splits == math.ceil(k / step)
    # on the tensor cores every split starts on a 64-row boundary, so none of
    # K9's scale blocks straddles two splits
    splits, rows = quant_kernels._splits(m, k, gn, 132, path)
    assert path != "tc" or rows % quant.DEFAULT_BLOCK == 0


@pytest.mark.parametrize("m,tk,path", [(1, 4096, "gemv"), (4, 4096, "gemv"), (5, 4096, "tc"),
                                       (8, 11264, "tc"), (64, 512, "tc"), (65, 4096, "fma"),
                                       (512, 4096, "fma"), (8, 8, "fma"), (64, 24, "fma"),
                                       (4, 24, "gemv")])
def test_rank1_path(m, tk, path):
    """The kernel of K1 and K9 by m and tk: the tensor cores for 4 < m <= 64 where a
    16-row mma step stays inside one k tile (tk % 16 == 0; pack_int4_tiled takes
    any divisor of k_pad), else the FMA tile kernel; gemv for m <= 4 whatever tk."""
    assert quant_kernels.TC_MAX_M == 64
    assert quant_kernels.int4_path(m, tk) == path


def _split_case(k, n, m, u_range, v_range, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-8, 8, (k, n))
    u = torch.from_numpy(rng.uniform(*u_range, k).astype(np.float32))
    v = torch.from_numpy(rng.uniform(*v_range, n).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    ref = quant_kernels.int4_matmul_rank1_plain(
        x, torch.from_numpy(quant.pack_int4_tiled(codes)), u, v)
    parts, rest = [], x * u  # x*u in f32, as the kernel forms it
    for _ in range(3):
        parts.append(rest.to(torch.bfloat16).float())
        rest = rest - parts[-1]
    q = torch.from_numpy(codes).double()

    def over(n_parts):
        """The share of outputs over phase 3's f32 gate when the first n_parts
        bf16 parts of x*u, each times the exact codes, are summed (in float64)
        and scaled by v/8."""
        y = (sum(h.double() @ q for h in parts[:n_parts]) * (v.double() * 0.125)).float()
        err = (y - ref).abs()
        return float((err > chip_smoke.INT4_ATOL + chip_smoke.INT4_RTOL * ref.abs()).float()
                     .mean())

    return x * u, parts, rest, over


@pytest.mark.parametrize("m", [5, 8, 16])
@pytest.mark.parametrize("k", [4096, 11008])
def test_split_xu_holds_the_f32_gate(k, m):
    """The tensor-core path's arithmetic at the 7B depths and phase 3's law of
    u and v: x*u formed in f32 and split into bf16 parts, each times the exact
    codes, summed, times v/8, against the plain version with phase 3's f32 gate
    (chip_smoke.py's INT4_ATOL + INT4_RTOL |plain|). Three parts (the kernel's)
    and two pass; the high part alone puts many outputs over the gate, so the
    gate sees a product that keeps only bf16(x*u)."""
    _, _, _, over = _split_case(k, 1024, m, (0.005, 0.035), (0.5, 1.5), k + m)
    assert over(3) == 0.0 and over(2) == 0.0
    assert over(1) > 0.1


def test_split_xu_in_three_parts_is_exact():
    """Three bf16 parts add up to x*u bit for bit (8 + 8 + 8 bits of f32's 24),
    so each product the kernel sums is the reference's f32 product. Two are not
    enough at the law of u and v of test_cuda_kernel_matches_plain (u, v in
    [0.5, 2], x*u of order 1, k = 1536): their 2^-17 puts outputs over the f32
    gate at m = 63, where three parts pass."""
    xu, parts, rest, over = _split_case(1536, 3000, 63, (0.5, 2.0), (0.5, 2.0), 7)
    assert torch.equal(rest, torch.zeros_like(rest))
    assert torch.equal(parts[0] + parts[1] + parts[2], xu)
    assert over(3) == 0.0
    assert over(2) > 0.0


def test_bf16_x_returns_bf16():
    _, tp = _rank1(512, 1024, 6)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 512)).astype(np.float32))
    got = quant_kernels.int4_matmul_rank1(x.to(torch.bfloat16), tp)
    ref = quant_kernels.int4_matmul_rank1(x.to(torch.bfloat16).float(), tp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref.to(torch.bfloat16).float().numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile_k", [None, 512])
@pytest.mark.parametrize("m", [1, 3, 5, 8, 16, 63, 64, 200])
def test_cuda_kernel_matches_plain(cuda_device, m, tile_k):
    """One k tile (the serving layout) and three (gk > 1); each path (gemv, the
    tensor cores at 4 < m <= 64, the FMA tile)."""
    jstack, tstack = _stack(1536, 3000, 3, 7, tile_k)
    dev = {key: v.to(cuda_device) for key, v in tstack.items()}
    x = torch.from_numpy(
        np.random.default_rng(m).standard_normal((m, 1536)).astype(np.float32)).to(cuda_device)
    got = quant_kernels.int4_matmul_rank1_stacked(x, dev, 2)
    ref = quant_kernels.int4_matmul_rank1_stacked(x, dev, 2, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=RTOL)


# faults planted in a copy of csrc/, each in the tensor-core kernel: (the code as
# written, as planted, (weights, m) of phase 3's case that must fail)
MLP_PROJ = ("mlp_proj", 11008, 4096, chip_smoke.INT4_7B_UV)
FAULTS = {
    "K1 only the high part of x*u": (
        "for (int s = 0; s < 3; ++s) mma_bf16(acc[p], a, b[0][s], b[1][s]);",
        "for (int s = 0; s < 1; ++s) mma_bf16(acc[p], a, b[0][s], b[1][s]);", (MLP_PROJ, 8)),
    "K1 third part of x*u dropped": (
        "for (int s = 0; s < 3; ++s) mma_bf16(acc[p], a, b[0][s], b[1][s]);",
        "for (int s = 0; s < 2; ++s) mma_bf16(acc[p], a, b[0][s], b[1][s]);",
        (chip_smoke.INT4_RAGGED, 64)),
    "K1 last 16-row step of a split skipped": (
        "for (int ks = k0 + warp * kTcStep; ks < k1; ks += kTcWarps * kTcStep) {",
        "for (int ks = k0 + warp * kTcStep; ks + kTcStep < k1; ks += kTcWarps * kTcStep) {",
        (MLP_PROJ, 8)),
    "K1 B not zeroed at rows >= k": ("xu[r] = xrow_ok && kr < k ? val : 0.f;",
                                     "xu[r] = xrow_ok ? val : 0.f;", (chip_smoke.INT4_RAGGED, 8)),
}


def test_kernel_source_holds_the_planted_lines():
    """The lines the card's fault tests plant faults in are in K1's source once
    each (so a rewrite of the kernel does not silently disarm them)."""
    text = build.KERNELS["int4_rank1_matmul"].source.read_text()
    for written, *_ in FAULTS.values():
        assert text.count(written) == 1, written
    assert chip_smoke.INT4_RAGGED[1] % 16  # the last 16-row step runs past k


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_planted_fault(cuda_device, fault, tmp_path, monkeypatch):
    """chip_smoke.py's phase 3 check fails for a K1 whose tensor-core product
    keeps only the high bf16 part of x*u, or drops its third part (seen only
    where x*u is of order 1: phase 3's ragged case), skips the last 16-row k
    step of each split, or lets the rows past k (random words) into the sum
    with x*u of column k - 1 (seen where k % 16 != 0: the ragged case)."""
    written, planted, ((_, k, n, uv), m) = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    real = build.KERNELS["int4_rank1_matmul"]
    text = (src / real.source.name).read_text()
    assert text.count(written) == 1
    (src / real.source.name).write_text(text.replace(written, planted))
    faulty = build.Kernel(real.name, str(src / real.source.name), real.replaces, real.entry,
                          real.argtypes)
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = chip_smoke.int4_weights(torch, gen, k, n, uv=uv)
    assert chip_smoke.int4_case(torch, gen, "sound", p, m)["path"] == "tc"
    monkeypatch.setitem(build.KERNELS, "int4_rank1_matmul", faulty)
    with pytest.raises(AssertionError, match="K1") as caught:
        chip_smoke.int4_case(torch, gen, fault, p, m)
    print(f"{fault}: {caught.value}")
