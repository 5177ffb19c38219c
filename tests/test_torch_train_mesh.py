"""Multi-GPU training in the port (the training plan of
fastmax_tpu_torch/parallel/sharding.py, the differentiable collectives, fit,
pretrain, finetune and bench_mfu on a mesh) on four gloo ranks on the CPU,
held against the JAX package's one-device step.

One group of ranks (collectives.spawn_local over torch_rank_checks.run_cases,
beside this file) runs every case while the tests compute the JAX references.
The model is the tiny LLaMA of tests/test_quant_pallas.py widened to four
heads (2 layers, 128 wide, n_head 4, n_query_groups 2), its JAX weights
carried over by from_numpy_params. Tolerances are the reference's sharded
forward's (tests/test_sharding.py): atol 2e-4, rtol 1e-3 on every step's loss
and on the parameters after two steps, at each (dp, fsdp, tp) mesh and with
each optimizer, the global-norm clip engaged; gradients at atol 1e-5 and rtol
1e-3 of float32 sums taken in another order.
"""

import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastmax_tpu.models import gpt as jgpt
from fastmax_tpu.models.config import Config as JaxConfig
from fastmax_tpu.training import finetune as jfinetune
from fastmax_tpu.training import fit as jfit
from fastmax_tpu.training import step as jstep
from fastmax_tpu.utils.args import TrainArgs as JaxTrainArgs
from fastmax_tpu_torch.parallel import collectives as col
from fastmax_tpu_torch.training import bench_mfu, finetune, fit, pretrain
from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs

WORLD = 4
TINY = dict(name="tiny-mesh", block_size=64, vocab_size=128, padded_vocab_size=128,
            n_layer=2, n_head=4, n_embd=128, n_query_groups=2, intermediate_size=256,
            rotary_percentage=1.0, parallel_residual=False, bias=False,
            _norm_class="RMSNorm", _mlp_class="LLaMAMLP")
MESHES = [(4, 1, 1), (2, 2, 1), (2, 1, 2), (1, 2, 2)]
OPTIMIZERS = ("adamw8bit", "adafactor", "lion")
# the clip engages: the first step's gradient norm is well above it
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=0, max_iters=2, max_norm=0.05,
             weight_decay=0.1)
ATOL, RTOL = 2e-4, 1e-3


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def sft_batch():
    """Four SFT rows with unequal numbers of ignored (-1) labels: the first
    rank's rows carry far fewer targets than the second's."""
    rng = np.random.default_rng(5)
    inputs = rng.integers(1, 128, (4, 24))
    labels = inputs.copy()
    for row, n in enumerate((20, 16, 3, 1)):
        labels[row, :n] = -1
    return inputs, labels


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jcfg = JaxConfig(**TINY)
    params = np_tree(jgpt.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (4, 17)) for _ in range(2)]
    cases = [(f"steps_{m}", "train_steps", dict(cfg=TINY, params=params, batches=batches,
                                                  mesh=m, train=dict(TRAIN, optimizer="adamw")))
             for m in MESHES]
    cases += [(f"opt_{name}", "train_steps", dict(
        cfg=TINY, params=params, batches=batches, mesh=(1, 2, 2),
        train=dict(TRAIN, optimizer=name))) for name in OPTIMIZERS]
    cases.append(("steps_dots", "train_steps", dict(
        cfg=TINY, params=params, batches=batches, mesh=(1, 2, 2),
        train=dict(TRAIN, optimizer="adamw"), remat="dots")))
    fm = dict(TINY, attn_alg="fastmax")
    cases.append(("fastmax_tp", "train_steps", dict(
        cfg=fm, params=params, batches=batches, mesh=(2, 1, 2),
        train=dict(TRAIN, optimizer="adamw"))))
    inputs, labels = sft_batch()
    cases.append(("sft", "sft_grads", dict(cfg=TINY, params=params, inputs=inputs,
                                           labels=labels, mesh=(2, 2, 1))))

    # pretrain.setup at dp 2, fsdp 2 (the reference's tests/test_training.py:303-327)
    src = tmp / "enwik8"
    src.write_bytes((np.arange(300_000) % 7 + 65).astype(np.uint8).tobytes())
    entry = dict(TINY, name="tiny-mesh-pt", vocab_size=256, padded_vocab_size=256)
    pt_train = dict(global_batch_size=4, micro_batch_size=4, max_iters=16, learning_rate=3e-3,
                    save_interval=1000, log_interval=4, lr_warmup_steps=4)
    common = dict(data_format="enwik8", logger_name="csv")
    cases.append(("pretrain", "pretrain_mesh", dict(
        entry=entry, kw=common, train=pt_train, out=str(tmp / "pt"), data=str(src),
        mesh=(2, 2, 1))))
    # a save at (2, 2, 1), then a resume at (1, 2, 2)
    rs_train = dict(pt_train, max_iters=3, save_interval=3, log_interval=1)
    cases.append(("save", "pretrain_mesh", dict(
        entry=entry, kw=common, train=rs_train, out=str(tmp / "rs"), data=str(src),
        mesh=(2, 2, 1), copy_state=str(tmp / "state3"))))
    cases.append(("resume", "pretrain_mesh", dict(
        entry=entry, kw=common, train=dict(rs_train, max_iters=5), out=str(tmp / "rs"),
        data=str(src), mesh=(1, 2, 2), resume=True)))

    # finetune.setup LoRA on an NF4 base at fsdp 2, tp 2 (the reference's :341-370)
    ex = np.random.default_rng(0)
    examples = [{"input_ids": ex.integers(1, 128, size=(24,)),
                 "labels": ex.integers(1, 128, size=(24,))} for _ in range(16)]
    data = tmp / "train.npz"
    np.savez_compressed(data, examples=np.asarray(examples, dtype=object))
    cases.append(("finetune", "finetune_mesh", dict(
        entry=dict(TINY, name="tiny-mesh-ft"), out=str(tmp / "ft"), mesh=(1, 2, 2),
        kw=dict(method="lora", data_path=str(data), quantize="bnb.nf4", logger_name="csv"),
        train=dict(global_batch_size=4, micro_batch_size=4, max_iters=4, learning_rate=3e-3,
                   save_interval=1000, log_interval=2, max_seq_length=24))))
    cases.append(("bench", "bench_mesh", dict(entry=dict(TINY, name="tiny-mesh-bench"), kw=dict(
        seq_len=32, micro_batch=4, iters=1, remat="full", fsdp=2))))

    import torch_rank_checks as rank_checks

    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(col.spawn_local, rank_checks.run_cases, WORLD, args=(cases,),
                        timeout=300)
    pool.shutdown(wait=False)
    return {"ranks": ranks, "params": params, "batches": batches, "jcfg": jcfg, "tmp": tmp,
            "src": src, "entry": entry, "rs_train": rs_train}


def result(world) -> dict:
    return world["ranks"].result()[0]


def jax_steps(world, optimizer: str):
    """Two steps of the JAX one-device step (fastmax_tpu/training/step.py) under
    the JAX package's optax chain: the losses, the params, and the first
    gradient's global norm (once an optimizer)."""
    memo = world.setdefault("jax_steps", {})
    if optimizer not in memo:
        memo[optimizer] = _jax_steps(world, optimizer)
    return memo[optimizer]


def _jax_steps(world, optimizer: str):
    jcfg = world["jcfg"]
    opt = jfit.build_optimizer(JaxTrainArgs(**TRAIN, optimizer=optimizer))
    params = jax.tree.map(jnp.asarray, world["params"])
    grads = jax.grad(jstep.make_loss_fn(jcfg))(params, jnp.asarray(world["batches"][0]))
    step = jstep.make_train_step(jcfg, opt, donate=False)
    state = opt.init(params)
    losses = []
    for b in world["batches"]:
        params, state, loss = step(params, state, jnp.asarray(b))
        losses.append(float(loss))
    return losses, flat(np_tree(params)), float(optax.global_norm(grads))


def assert_steps_match(got: dict, losses, params) -> None:
    np.testing.assert_allclose(got["losses"], losses, atol=ATOL, rtol=RTOL)
    mine = flat(got["params"])
    assert sorted(mine) == sorted(params)
    for name, want in params.items():
        np.testing.assert_allclose(mine[name], want, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_mesh_steps_match_the_jax_step(world, mesh):
    """Two AdamW steps with the clip engaged at each (dp, fsdp, tp) mesh give the
    JAX one-device step's losses and parameters."""
    losses, params, norm = jax_steps(world, "adamw")
    assert norm > 4 * TRAIN["max_norm"], norm
    got = result(world)[f"steps_{mesh}"]
    assert got["kept_whole"] == []  # at tp 2 every sub-block is split
    assert_steps_match(got, losses, params)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_sharded_optimizers_match_the_jax_optimizers(world, name):
    """adamw8bit (whole blocks where a shard holds them, the whole leaf's
    moments where it does not), adafactor (statistics summed over the split
    axes) and lion at fsdp 2, tp 2 against the JAX package's optimizers."""
    losses, params, _ = jax_steps(world, name)
    assert_steps_match(result(world)[f"opt_{name}"], losses, params)


def test_selective_remat_under_fsdp_and_tp(world):
    """remat "dots" recomputes each block, its gathers and sums included, in
    the same order on every rank: the same steps as the JAX step."""
    losses, params, _ = jax_steps(world, "adamw")
    assert_steps_match(result(world)["steps_dots"], losses, params)


def test_the_fastmax_arm_splits_its_heads_at_tp_2(world):
    """The linear arm's attention is split by heads in training (serving keeps
    it whole for its running state): two steps at (2, 1, 2) against the port's
    own one-device step (tests/test_torch_training.py holds that one against
    the JAX package's Pallas route)."""
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.weights import from_numpy_params, to_numpy_params
    from fastmax_tpu_torch.training.step import make_train_step

    cfg = Config(**dict(TINY, attn_alg="fastmax"))
    params = from_numpy_params(world["params"], "cpu")
    opt = fit.build_optimizer(TrainArgs(**TRAIN, optimizer="adamw"))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses = [float(step(params, state, torch.as_tensor(b))[2]) for b in world["batches"]]
    got = result(world)["fastmax_tp"]
    assert got["kept_whole"] == []
    assert_steps_match(got, losses, flat(to_numpy_params(params)))


def test_masked_sft_loss_is_the_global_batch_mean(world):
    """SFT rows with unequal -1 label counts: the loss and gradients are the
    masked mean over the whole batch (the JAX package's sft_loss_fn), not the
    mean of the ranks' means."""
    inputs, labels = sft_batch()
    params = jax.tree.map(jnp.asarray, world["params"])
    loss, grads = jax.value_and_grad(jfinetune.sft_loss_fn(world["jcfg"]))(
        params, (jnp.asarray(inputs), jnp.asarray(labels)))
    got = result(world)["sft"]
    np.testing.assert_allclose(got["loss"], float(loss), atol=ATOL, rtol=RTOL)
    # the mean of the four ranks' means is another number
    per_rank = [float(jfinetune.sft_loss_fn(world["jcfg"])(
        params, (jnp.asarray(inputs[i:i + 1]), jnp.asarray(labels[i:i + 1]))))
        for i in range(4)]
    assert abs(np.mean(per_rank) - float(loss)) > 100 * ATOL
    want = flat(np_tree(grads))
    assert sorted(got["grads"]) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got["grads"][name], w, atol=1e-5, rtol=RTOL, err_msg=name)


def test_pretrain_setup_on_a_mesh_learns(world):
    """pretrain.setup at dp 2, fsdp 2 (the reference's tests/test_training.py:
    303-327): the loss falls by 10 %."""
    got = result(world)["pretrain"]
    assert got["step"] == 16
    assert got["losses"][-1] < got["losses"][0] * 0.9, got["losses"]


def test_a_state_saved_at_one_mesh_resumes_at_another(world, tmp_path, monkeypatch):
    """Saved whole by rank 0 at (2, 2, 1), resumed at (1, 2, 2) to step 5: the
    deploy checkpoint equals one rank's resume of the same saved state."""
    from fastmax_tpu_torch.models import config as config_mod
    from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint

    got = result(world)
    assert got["save"]["step"] == 3 and got["resume"]["step"] == 5
    reg = dict(config_mod.registry())
    reg[world["entry"]["name"]] = dict(world["entry"])
    monkeypatch.setattr(config_mod, "registry", lambda: reg)
    shutil.copytree(world["tmp"] / "state3", tmp_path / "state")
    pretrain.setup(model_name=world["entry"]["name"], data_format="enwik8",
                   train=TrainArgs(**dict(world["rs_train"], max_iters=5)),
                   io=IOArgs(train_data_dir=world["src"], out_dir=tmp_path, resume=True),
                   device="cpu")
    want = load_flat_checkpoint(tmp_path / "final")
    mine = load_flat_checkpoint(world["tmp"] / "rs" / "final")
    assert sorted(mine) == sorted(want)
    for name in want:
        np.testing.assert_allclose(np.asarray(mine[name]), np.asarray(want[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_finetune_lora_on_an_nf4_base_at_fsdp_and_tp(world):
    """finetune.setup LoRA on an NF4 base at fsdp 2, tp 2 (the reference's
    tests/test_training.py:341-370): rank 0 writes the whole delta file."""
    got = result(world)["finetune"]
    assert any("lora" in k for k in got["delta"])
    a = got["delta"]["blocks.attn.attn.lora_A"]
    assert a.shape[0] == TINY["n_layer"] and np.isfinite(a).all()
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()


def test_bench_mfu_at_fsdp_2(world):
    """bench_mfu.run on four ranks at fsdp 2 (a data axis of 2): the step of
    the whole micro-batch, one rank's loss."""
    got = result(world)["bench"]
    assert got["devices"] == WORLD and got["n_params"] > 0 and got["mfu"] is None
    assert np.isfinite(got["loss"]) and got["step_time_ms"] > 0


@pytest.mark.parametrize("trainer", ["pretrain", "finetune", "bench_mfu"])
def test_started_alone_each_trainer_names_its_torchrun_line(tmp_path, trainer):
    """A trainer started alone at dp * fsdp * tp > 1 never trains on one rank:
    it raises, naming the torchrun line."""
    module = f"fastmax_tpu_torch.training.{trainer}"
    with pytest.raises(RuntimeError, match=f"torchrun --nproc_per_node 2 -m {module}"):
        if trainer == "pretrain":
            pretrain.setup(dp=2, device="cpu", io=IOArgs(out_dir=tmp_path))
        elif trainer == "finetune":
            finetune.setup(model_name="pythia-14m", data_path=tmp_path / "x.npz", tp=2,
                           device="cpu", io=IOArgs(out_dir=tmp_path))
        else:
            bench_mfu.run(model_name="pythia-14m", fsdp=2, device="cpu")
