"""The port's scaling-efficiency harness (fastmax_tpu_torch/parallel/scaling_bench.py)
on the CPU, as tests/test_bench_tools.py checks the reference's: meshes of
one rank (the unsharded step in the test's process) and two gloo ranks
(fsdp 2) train pythia-14m and report positive rates and step times, with an
efficiency of exactly 1 at one rank. The run
goes through the command line (``run``'s parameters as flags, the result
printed as JSON keyed by size). The harness refuses to run without CUDA
unless asked for the CPU."""

import contextlib
import io
import json

import pytest
import torch

from fastmax_tpu_torch.parallel import scaling_bench


@pytest.fixture(scope="module")
def bench():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = scaling_bench.main(["--model_name", "pythia-14m", "--seq_len", "64",
                                  "--per_device_batch", "1", "--max_devices", "2",
                                  "--device", "cpu", "--backend", "gloo", "--iters", "2"])
    return res, out.getvalue()


def test_scaling_bench_runs(bench):
    res, _ = bench
    assert sorted(res) == [1, 2]
    for r in res.values():
        assert r["tokens_per_sec"] > 0 and r["step_time_s"] > 0
    assert res[1]["efficiency"] == 1.0
    assert res[2]["efficiency"] == pytest.approx(
        res[2]["tokens_per_sec"] / (2 * res[1]["tokens_per_sec"]))
    assert res[2]["tokens_per_sec"] == pytest.approx(2 * 64 / res[2]["step_time_s"])


def test_scaling_bench_prints_each_size_and_the_json(bench):
    res, printed = bench
    lines = printed.splitlines()
    assert lines[0].startswith("devices=1 (this process, cpu): ")
    assert "efficiency 100.00%" in lines[0]
    assert lines[1].startswith("devices=2 (gloo, cpu): ")
    assert json.loads("\n".join(lines[2:])) == {str(k): v for k, v in res.items()}


def test_scaling_bench_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is here: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling_bench.run("pythia-14m", max_devices=1)
