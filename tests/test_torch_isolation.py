"""The port stands alone: it imports neither jax nor fastmax_tpu, its entry
points default to the card and refuse to run without one, and a CUDA tensor
never reaches a plain PyTorch version unasked."""

import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from fastmax_tpu_torch.inference.engine import InferenceEngine, default_device
from fastmax_tpu_torch.kernels import build
from fastmax_tpu_torch.models.config import Config
from fastmax_tpu_torch.models import gpt
from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4
from fastmax_tpu_torch.models.weights import from_numpy_params
from fastmax_tpu_torch.training import finetune, pretrain

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
TINY = dict(block_size=64, vocab_size=128, padded_vocab_size=128, n_layer=2, n_head=4,
            n_embd=128, n_query_groups=2, intermediate_size=256, _norm_class="RMSNorm",
            _mlp_class="LLaMAMLP", bias=False)


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_no_jax_and_no_reference_package_imported():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fastmax_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'fastmax_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "for sub in ('training.pretrain', 'training.fit', 'training.step', 'data.lm_datasets',\n"
        "            'data.packed_dataset', 'utils.args', 'utils.flops', 'utils.logging',\n"
        "            'utils.loss', 'ops.fastmax', 'ops.fastmax_kernels', 'training.finetune',\n"
        "            'models.lora', 'ops.blockwise_attention', 'utils.checkpoint'):\n"
        "    assert pkg.__name__ + '.' + sub in names, sub\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_clean_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_cuda():
    cfg = Config(**TINY)
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    params = build_fake_7b_int4(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fake_7b_int4(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy_params({"wte": params["wte"].float().numpy()})
    with pytest.raises(RuntimeError, match="CUDA"):
        gpt.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.setup(model_name="easy-transformer-fastmax")
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.setup(model_name="Llama-2-7b-hf", quantize="bnb.nf4", data_path="unused.npz")


def test_cuda_tensor_never_takes_the_plain_version():
    fake_cuda = types.SimpleNamespace(device=torch.device("cuda"))
    if torch.cuda.is_available():
        assert build.use_kernel(fake_cuda)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build.use_kernel(fake_cuda)
    assert build.use_kernel(fake_cuda, plain=True) is False
    assert build.use_kernel(torch.zeros(2)) is False
    with pytest.raises(ValueError):
        build.use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        build.use_kernel(torch.zeros(2), fake_cuda)


def test_kernels_build_only_on_a_cuda_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the build itself is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError):
        build.build_all()
    with pytest.raises(RuntimeError):
        build.KERNELS["int4_rank1_matmul"].lib()
    for k in build.KERNELS.values():
        assert k.source.is_file() and k.source.suffix == ".cu"
        assert k.replaces.startswith("fastmax_tpu/ops/")
        assert (REPO / k.replaces.split(":")[0]).is_file()
    rel = build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    assert rel in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env=_clean_env(), cwd=script.parent, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
