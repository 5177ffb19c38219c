"""The port's eight-mode multi-rank dry run (fastmax_tpu_torch/graft_entry.py,
the counterpart of __graft_entry__.dryrun_multichip) on eight gloo ranks on
the CPU: every mode holds its loss within the reference's relative 2e-3 of
the unsharded loss, and the tp int4 decode's greedy tokens equal the
unsharded engine's. Without CUDA and without device="cpu" it raises; there
is no fallback. The flagship entry's configuration is the reference's, and
its forward runs on the CPU when asked.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastmax_tpu_torch import graft_entry as ge

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__ as jge  # noqa: E402

MODES = ["dp/fsdp/tp", "sp (ring attention x2)", "pp (2 stages x 2 micro)", "ep (4 experts)",
         "hybrid (2 granules: data/DCN x fsdp,model/ICI)",
         "fsdp x tp x sp (seq/2 x tp/2 x fsdp/2)", "pp+fsdp (2 stages x fsdp/2)"]


@pytest.fixture(scope="module")
def dryrun():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = ge.dryrun_multichip(8, device="cpu")
    return report, out.getvalue()


@pytest.mark.parametrize("mode", MODES)
def test_dryrun_mode_matches_the_unsharded_loss(dryrun, mode):
    report, printed = dryrun
    assert report["mesh"] == (2, 2, 2)
    got = report["modes"][mode]
    assert np.isfinite(got["loss"]) and got["rel"] < ge.PARITY_TOL
    assert f"  parity {mode}: loss={got['loss']:.6f} ref={got['ref']:.6f}" in printed


def test_dryrun_tp_int4_decode_tokens_identical(dryrun):
    report, printed = dryrun
    tokens = np.asarray(report["modes"]["tp int4 decode"]["tokens"])
    assert tokens.shape == (1, 24)
    assert "  parity tp int4 decode (tp/2 x fsdp/2): 12 greedy tokens identical" in printed
    assert printed.strip().endswith(
        "dryrun_multichip ok: all modes match the unsharded reference loss")
    assert len(report["launches"]) == 8


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factors_as_the_reference(n):
    model = 2 if n % 2 == 0 else 1
    fsdp = 2 if (n // model) % 2 == 0 else 1
    assert ge.mesh_factors(n) == (n // model // fsdp, fsdp, model)


def test_dryrun_and_entry_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is here: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        ge.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ge.entry()


def test_entry_flagship_forward_on_the_cpu():
    """entry(device="cpu"): the reference's flagship configuration, bf16, and
    a forward of its (1, 32) batch to finite (1, 32, 32000) logits."""
    want = jge._flagship_config()
    got = ge._flagship_config()
    for field in ("name", "block_size", "vocab_size", "padded_vocab_size", "n_layer", "n_head",
                  "n_embd", "n_query_groups", "rotary_percentage", "parallel_residual", "bias",
                  "intermediate_size", "norm_class_name", "mlp_class_name", "head_size"):
        assert getattr(got, field) == getattr(want, field), field
    fn, (params, idx) = ge.entry(device="cpu")
    assert params["wte"].dtype == torch.bfloat16 and tuple(idx.shape) == (1, 32)
    with torch.no_grad():
        logits = fn(params, idx)
    assert tuple(logits.shape) == (1, 32, 32000) and torch.isfinite(logits.float()).all()
