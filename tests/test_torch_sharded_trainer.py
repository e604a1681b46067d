"""The sharded trainer and its checkpoints, on a 2x2 gloo world of CPU
ranks, against the port's single-process trainer.

minicpm-2b smoke (two periods), 8x32 tokens a step, AdamW at lr 1e-3:

* ``Trainer(rules=ShardingRules(mesh))`` takes 3 steps: every loss within
  2e-3 of the single-process trainer's from the same weights and data;
  step 1's gradients (before AdamW, which would amplify differences in
  near-zero gradients) within 1e-4 of each leaf's largest magnitude, also
  with the backward pass on a thread of its own (as autograd runs it on
  the card); on both backends;
* qwen2-moe-a2.7b smoke with ``moe_impl="a2a"`` (the expert all-to-all
  over the 4 ranks), where no token drops: step 1's loss and gradients
  and one ``Trainer`` step's loss match the single-process GShard step
  the same way, on both backends;
* a ``microbatches=2`` step matches the single-process one the same way
  (int8 compression under rules: ``test_torch_sharded_train.py``, on 2x4);
* the port of ``test_elastic_restore_across_mesh_sizes``: a single-process
  checkpoint restores onto the 2x2 mesh bit-equal, at step 7, on the
  placements ``tree_shardings`` gives; and a checkpoint the 2x2 trainer
  writes (rank 0, unsharded) restores single-process bit-equal;
* the launcher on two ranks under ``torch.distributed.run``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_world
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer, value_and_grad

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "minicpm-2b"
BACKENDS = {"torch": {}, "kernel": {"contract_backend": "kernel",
                                    "contract_strategy": "native"}}
OPT = {"lr": 1e-3, "warmup_steps": 1}


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 2), ("data", "model"))
    yield w
    w.close()


def _setup(backend):
    over = dict(n_periods=2, **BACKENDS[backend])
    cfg = get_config(ARCH, smoke=True).with_(**over)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    data = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    return over, cfg, params, tree_map(lambda t: t.numpy(), params), data


def _train(cfg, params, data, steps, **tcfg):
    tr = Trainer(cfg, TrainConfig(opt=AdamWConfig(**OPT), **tcfg), params, SyntheticLM(**data))
    return tr, [h["loss"] for h in tr.run(steps)]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_trainer_matches_single_process(world, backend):
    over, cfg, params, np_params, data = _setup(backend)
    _, want = _train(cfg, params, data, 3)
    got = world.run(torch_world.sharded_train, ARCH, over, np_params, data,
                    {"opt": OPT}, 3)
    for r in got:
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("thread", [False, True], ids=["same_thread", "backward_thread"])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_step_one_gradients_match(world, backend, thread):
    over, cfg, params, np_params, data = _setup(backend)
    batch = next(SyntheticLM(**data))
    loss, _, grads = value_and_grad(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    got = world.run(torch_world.sharded_grads, ARCH, over, np_params, batch, thread)
    for r in got:
        assert abs(r["loss"] - float(loss)) < 2e-3
        for g, mine in zip(tree_leaves(grads), r["grads"]):
            scale = float(g.abs().max())
            np.testing.assert_allclose(mine, g.numpy(), rtol=0, atol=1e-4 * max(scale, 1e-30))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_sharded_step_matches_single_process(world, backend):
    """qwen2-moe-a2.7b smoke with ``moe_impl="a2a"`` at a capacity factor
    where no token drops: under rules the MoE layers run the expert
    all-to-all over the 4 ranks, and step 1's loss and gradients match
    the single-process (GShard) step's as above; so does one
    ``Trainer(rules=)`` step's loss."""
    arch = "qwen2-moe-a2.7b"
    m = get_config(arch, smoke=True).moe
    over = dict(n_periods=2, moe_impl="a2a", moe=dataclasses.replace(m, capacity_factor=64.0),
                **BACKENDS[backend])
    cfg = get_config(arch, smoke=True).with_(**over)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    np_params = tree_map(lambda t: t.numpy(), params)
    data = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    batch = next(SyntheticLM(**data))
    loss, _, grads = value_and_grad(cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    for r in world.run(torch_world.sharded_grads, arch, over, np_params, batch):
        assert abs(r["loss"] - float(loss)) < 2e-3
        for g, mine in zip(tree_leaves(grads), r["grads"]):
            scale = float(g.abs().max())
            np.testing.assert_allclose(mine, g.numpy(), rtol=0, atol=1e-4 * max(scale, 1e-30))
    _, want = _train(cfg, params, data, 1)
    for r in world.run(torch_world.sharded_train, arch, over, np_params, data, {"opt": OPT}, 1):
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=2e-3)


def test_sharded_microbatches_match(world):
    over, cfg, params, np_params, data = _setup("torch")
    _, want = _train(cfg, params, data, 1, microbatches=2)
    got = world.run(torch_world.sharded_train, ARCH, over, np_params, data,
                    {"opt": OPT, "microbatches": 2}, 1)
    for r in got:
        assert np.isfinite(r["losses"]).all()
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=2e-3)


def test_elastic_restore_across_mesh_sizes(world, tmp_path):
    """Single-process → 2x2: bit-equal, step 7, the ``tree_shardings``
    placements (internlm2-20b smoke, one period, as in the reference)."""
    over = dict(n_periods=1)
    cfg = get_config("internlm2-20b", smoke=True).with_(**over)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    save_checkpoint(str(tmp_path), 7, params)
    for r in world.run(torch_world.sharded_restore, "internlm2-20b", over, str(tmp_path)):
        assert r["step"] == 7
        assert r["placements"] == r["want"]
        for a, b in zip(tree_leaves(params), r["leaves"]):
            np.testing.assert_array_equal(a.numpy(), b)


def test_sharded_checkpoint_restores_single_process(world, tmp_path):
    """2x2 trainer → single process: rank 0 writes the unsharded leaves,
    and a single-process trainer restores them bit-equal, at the step and
    data cursor the sharded one reached."""
    over, cfg, params, np_params, data = _setup("torch")
    got = world.run(torch_world.sharded_train, ARCH, over, np_params, data,
                    {"opt": OPT}, 2, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["MANIFEST.json", "step_0000000002"]
    tr = Trainer(cfg, TrainConfig(opt=AdamWConfig(**OPT), ckpt_dir=str(tmp_path)),
                 tree_map(torch.zeros_like, params), SyntheticLM(**data))
    assert tr.restore() == 2 and tr.data.step == 2
    for a, b in zip(tree_leaves(tr.params), got[0]["params"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_train_cli_on_two_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", "--arch", "minicpm-2b", "--smoke",
         "--device", "cpu", "--mesh", "1x2", "--steps", "2", "--seq-len", "16",
         "--batch", "2"],
        env=env, capture_output=True, text=True, timeout=240, stdin=subprocess.DEVNULL,
        cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("step 2: loss=") == 1          # rank 0 alone prints
    assert "mesh: 1x2 over 2 cpu ranks" in proc.stdout
