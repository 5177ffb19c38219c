"""The split route of the int8 decode-attention kernel K2
(fastmax_tpu_torch/csrc/int8_decode_attention.cu, chosen by
ops/decode_attention.decode_splits).

On the CPU: decode_splits gives a route for every shape the reference takes,
from the shapes alone; the one-block kernel only where its shared memory fits;
the wrapper's copies of the kernel's constants and shared-memory formulas match
the source; the lines the fault tests plant faults in are in the source once.

On the card (marked ``cuda``, skipped here): the split route against the plain
version at phase 4's chunk edges, in bf16 and f32, with chip_smoke.py's gates
(bf16: the max and the mean gates); the same bits on a repeat; the one-block and
split routes within the gates of each other; zeros for a slot with pos < 0; a
CUDA graph replay equal to the eager call; and a copy of ``csrc/`` with each of
four faults planted, which the checks must catch. This file imports no JAX:
the card's tests compare with the plain PyTorch version."""

import inspect
import re
import shutil

import pytest
import torch

import chip_smoke
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.ops import decode_attention as da

SOURCE = build.KERNELS["int8_decode_attention"].source


def _eligible_shapes():
    for d in (64, 128):
        for s in range(128, 8 * 2**20 // (4 * d) + 1, 128):
            for r in (1, 2, 4, 8):
                for bg in (1, 8, 32, 256, 1024):
                    yield bg, s, r, d


def test_decode_splits_takes_every_eligible_shape():
    """Every (B*G, S, R, d) the reference takes at R <= 8 gets a route the kernel
    takes: the split at chunks of at most MAX_CHUNK positions, at most MAX_SPLITS of
    them covering S, within shared memory for either q dtype; or the one-block kernel
    where its shared memory fits."""
    for bg, s, r, d in _eligible_shapes():
        assert da.int8_decode_eligible(1, d, s, r)
        nsplit = da.decode_splits(bg, s, r, d)
        if nsplit == 1:
            assert da.one_block_smem(r, s, d) <= da._SMEM_LIMIT, (bg, s, r, d)
            continue
        chunk = da.split_chunk(s, nsplit)
        assert chunk % 64 == 0 and chunk <= da.MAX_CHUNK, (bg, s, r, d, chunk)
        assert nsplit == -(-s // chunk) and nsplit <= da.MAX_SPLITS, (bg, s, r, d, nsplit)
        assert da.split_smem(r, chunk, d, nsplit, 4) <= da._SMEM_LIMIT, (bg, s, r, d)


def test_decode_splits_reads_the_shapes_only():
    """The route depends on (B*G, S, R, d) alone, never on the positions: the call
    stays free of host syncs and can be captured in a CUDA graph. Llama-2-7B batch 1
    (S = 1024) takes 16 chunks of 64, 8 slots at S = 4096 16 chunks of 256."""
    assert list(inspect.signature(da.decode_splits).parameters) == ["bg", "s", "r", "d"]
    assert da.decode_splits(32, 1024, 1, 128) == 16
    assert da.split_chunk(1024, 16) == 64
    assert da.decode_splits(256, 4096, 1, 128) == 16
    assert da.split_chunk(4096, 16) == 256


def test_one_block_route_only_where_it_fits():
    """decode_splits takes the one-block kernel only where the split cannot take the
    shape and the one-block kernel's softmax row fits in shared memory; asked for it
    where it does not fit, the wrapper raises before any launch."""
    assert da.decode_splits(1, 128, 200, 128) == 1  # a split chunk of 200 rows does not fit
    assert da.one_block_smem(8, 16384, 128) > da._SMEM_LIMIT
    assert da.decode_splits(2, 16384, 8, 128) > 1
    q = torch.zeros((2, 8, 1, 128), dtype=torch.bfloat16)
    kc = torch.zeros((1, 2, 1, 16384, 128), dtype=torch.int8)
    ks = torch.zeros((1, 2, 1, 16384))
    with pytest.raises(ValueError, match="shared memory"):
        da._launch(q, kc, kc, ks, ks, 0, 5, 128 ** -0.5, split=1)
    with pytest.raises(ValueError, match="nsplit=0"):
        da._launch(q, kc, kc, ks, ks, 0, 5, 128 ** -0.5, split=0)


def _constant(name: str) -> int:
    found = re.findall(rf"constexpr \w+ {name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_wrapper_mirrors_the_kernel_constants():
    """The wrapper's copies of the source's constants, and the mbarrier bytes they give,
    are the source's (split_smem and split_chunk repeat the source's formulas)."""
    assert da._SPLIT_WARPS == _constant("kSplitThreads") // 32
    assert da._ROWS_PER_PASS == _constant("kRowsPerPass")
    assert da._TILE == _constant("kTile")
    assert da.MAX_CHUNK == _constant("kMaxChunk")
    assert da.MAX_SPLITS == _constant("kMaxSplits")
    assert _constant("kSlots") == 2
    assert da._SMEM_LIMIT == _constant("kSmemMax")


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(7)


def _edge_cases(dtype):
    """Phase 4's cases at the split's chunk edges, and the mixed batch, in ``dtype``."""
    c1 = da.split_chunk(1024, chip_smoke.attn_split_route(da, 1, 32, 32, 1024, 128))
    c64 = da.split_chunk(512, chip_smoke.attn_split_route(da, 1, 32, 32, 512, 64))
    return [(1, 32, 32, 1024, 128, dtype, [(c1 - 1,), (c1,), (2 * c1,), (1023,)]),
            (1, 32, 32, 512, 64, dtype, [(c64 - 1,), (c64,), (511,)]),
            (4, 32, 32, 1024, 128, dtype, [(0, c1 - 1, c1 + 5, 1023)]),
            (2, 32, 8, 1024, 128, dtype, [(1023, 300), (c1, 0)])]


def _split_only(gen, case):
    b, hq, g, s, d, dtype, positions = case
    nsplit = chip_smoke.attn_split_route(da, b, hq, g, s, d)
    assert nsplit > 1
    return chip_smoke.attn_case(torch, gen, b, hq, g, s, d, dtype, positions, routes=(nsplit,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_route_matches_plain_at_the_edges(card, dtype):
    """The split route against the plain version at the chunk edges (the last
    position of a chunk, the first of the next), D = 64, slots in different chunks
    with one at pos 0, R = 4; bf16 by the max and the mean gates, f32 by 1e-4."""
    for case in _edge_cases(dtype):
        _split_only(card, case)


@pytest.mark.cuda
def test_split_route_repeats_bit_for_bit(card):
    chip_smoke.attn_repeats(torch, card)


@pytest.mark.cuda
def test_routes_agree(card):
    """The one-block kernel and the split route lie within the gates of each other."""
    kc, vc, ks, vs = chip_smoke.attn_inputs(torch, card, 1, 2, 32, 1024, 128)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((2, 32, 1, 128), generator=card, device="cuda").to(dtype)
        pos = torch.tensor([1023, 100], dtype=torch.int32, device="cuda")
        one = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5,
                                               split=1)
        split = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5)
        chip_smoke.attn_held(torch, f"one-block against split, {dtype}", split, one, dtype)


@pytest.mark.cuda
def test_empty_slot_gives_zeros(card):
    """A slot with pos < 0 attends nothing: zeros on both routes, not NaN."""
    kc, vc, ks, vs = chip_smoke.attn_inputs(torch, card, 1, 2, 32, 1024, 128)
    q = torch.randn((2, 32, 1, 128), generator=card, device="cuda").to(torch.bfloat16)
    pos = torch.tensor([-1, 500], dtype=torch.int32, device="cuda")
    for split in (1, None):
        out = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5,
                                               split=split)
        assert bool((out[0] == 0).all()) and bool(torch.isfinite(out[1]).all()), split


@pytest.mark.cuda
def test_unaligned_q_gives_the_aligned_result(card):
    """q as a contiguous view 2 bytes off a 16-byte boundary (the split's bulk copies
    need 16) gives the bits of the same values at an aligned address."""
    kc, vc, ks, vs = chip_smoke.attn_inputs(torch, card, 1, 1, 32, 1024, 128)
    flat = torch.randn(32 * 128 + 1, generator=card, device="cuda").to(torch.bfloat16)
    q = flat[1:].view(1, 32, 1, 128)
    assert q.data_ptr() % 16
    pos = torch.tensor([700], dtype=torch.int32, device="cuda")
    got = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5)
    ref = da.int8_decode_attention_stacked(q.clone(), kc, vc, ks, vs, 0, pos, scale=128 ** -0.5)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_split_call_replays_in_a_cuda_graph(card):
    """The split route's three launches capture in a CUDA graph (no host sync, the
    route read from the shapes), and a replay gives the eager call's bits."""
    kc, vc, ks, vs = chip_smoke.attn_inputs(torch, card, 1, 8, 32, 4096, 128)
    q = torch.randn((8, 32, 1, 128), generator=card, device="cuda").to(torch.bfloat16)
    pos = torch.tensor([3000, 0, 255, 256, 1000, 2047, 4000, 4095], dtype=torch.int32,
                       device="cuda")
    eager = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, pos, scale=128 ** -0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# faults planted in a copy of csrc/: (the code as written, as planted), each held on
# the bf16 edge cases of the split route
FAULTS = {
    "K2 last split's sum dropped": (
        "        for (int i = 0; i < nact; ++i)\n"
        "          l += __shfl_sync(0xffffffffu, i < 32 ? t_lo : t_hi, i & 31);",
        "        for (int i = 0; i < nact - 1; ++i)\n"
        "          l += __shfl_sync(0xffffffffu, i < 32 ? t_lo : t_hi, i & 31);"),
    "K2 p rounded against the split's own max and sum": (
        "        const float p = expf(pv[r * chunk + j] - ml[2 * r]) / ml[2 * r + 1];\n"
        "        pv[r * chunk + j] = to_f32(from_f32<T>(p * vsb[j]));",
        "        const float2 own = st[r * sst + it.split];\n"
        "        const float p = expf(pv[r * chunk + j] - own.x) / own.y;\n"
        "        pv[r * chunk + j] = to_f32(from_f32<T>(p * vsb[j])) *\n"
        "                            (own.y * expf(own.x - ml[2 * r]) / ml[2 * r + 1]);"),
    "K2 mask one position late": ("  return max(0, min(pos_b + 1, s_len));",
                                  "  return max(0, min(pos_b + 2, s_len));"),
    "K2 first split's partial left out of the combine": (
        "  for (int sp = 0; sp < nact; ++sp) s += __ldcg(part + (head * nsplit + sp) * D + d);",
        "  for (int sp = 1; sp < nact; ++sp) s += __ldcg(part + (head * nsplit + sp) * D + d);"),
}


def _planted(tmp_path, fault):
    written, planted = FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    real = build.KERNELS["int8_decode_attention"]
    text = (src / real.source.name).read_text()
    assert text.count(written) == 1, f"{written!r} is not in {real.source.name} once"
    (src / real.source.name).write_text(text.replace(written, planted))
    return build.Kernel(real.name, str(src / real.source.name), real.replaces, real.entry,
                        real.argtypes)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_checks_catch_a_planted_fault(fault, tmp_path, monkeypatch, card):
    """chip_smoke.py's check of the split route fails for K2 built with the last
    split's sum left out of l, with p * v_scale rounded against the split's own max
    and sum and the partial rescaled after (flash-decoding's form: only the mean gate
    sees it), with the mask one position late (at pos = chunk - 1 it opens the next
    chunk), or with the first split's partial left out of the combine."""
    faulty = _planted(tmp_path, fault)
    cases = _edge_cases(torch.bfloat16)
    for case in cases:  # sound
        _split_only(card, case)
    monkeypatch.setitem(build.KERNELS, "int8_decode_attention", faulty)
    with pytest.raises(AssertionError, match="K2") as caught:
        for case in cases:
            _split_only(card, case)
    print(f"{fault}: {caught.value}")


def test_kernel_source_holds_the_planted_lines():
    """The lines the card's fault tests plant faults in, and the loops that
    tools/k2_ab.py --bare empties, are in K2's source once each (so a rewrite of the
    kernel does not silently disarm them)."""
    from fastmax_tpu_torch.tools import k2_ab

    text = SOURCE.read_text()
    for written, _ in (*FAULTS.values(), *k2_ab.LOOPS):
        assert text.count(written) == 1, written
