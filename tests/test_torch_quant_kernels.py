"""The port's rank-1 int4 matmul (fastmax_tpu_torch/ops/quant_kernels.py)
against the Pallas kernels of fastmax_tpu/ops/quant_pallas.py, run in
interpret mode as the JAX package's own tests run them.

On the CPU the port's wrappers take the plain PyTorch version; the CUDA
kernel is compared with it by the ``cuda``-marked test (skipped without a
card) and by chip_smoke.py. Tolerances: atol 2e-4, rtol 2e-3 against the
Pallas kernels (tests/test_quant_pallas.py); stacked vs per-layer 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmax_tpu.ops import quant as jquant
from fastmax_tpu.ops import quant_pallas as jqp
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


@pytest.mark.parametrize("m", [1, 3, 64, 512])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)])
def test_kernel_k_splits_cover_k(m, k, n):
    """The split-k plan for the CUDA kernel covers every row once, with no
    empty split, and keeps a 132-SM card busy."""
    gn = (n + 1023) // 1024
    splits, rows = quant_kernels._splits(m, k, gn, 132)
    assert splits >= 1 and rows % 32 == 0
    assert (splits - 1) * rows < k <= splits * rows
    gemv = m <= quant_kernels.GEMV_MAX_M
    per_split = gn * (4 if gemv else 8 * ((m + 63) // 64))
    most = (k + (127 if gemv else 31)) // (128 if gemv else 32)
    assert per_split * splits >= 132 or splits == most


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
@pytest.mark.parametrize("m", [1, 3, 64, 200])
def test_cuda_kernel_matches_plain(cuda_device, m, tile_k):
    """One k tile (the serving layout) and three (gk > 1)."""
    jstack, tstack = _stack(1536, 3000, 3, 7, tile_k)
    dev = {key: v.to(cuda_device) for key, v in tstack.items()}
    x = torch.from_numpy(
        np.random.default_rng(m).standard_normal((m, 1536)).astype(np.float32)).to(cuda_device)
    got = quant_kernels.int4_matmul_rank1_stacked(x, dev, 2)
    ref = quant_kernels.int4_matmul_rank1_stacked(x, dev, 2, plain=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=RTOL)
