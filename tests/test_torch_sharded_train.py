"""The port of ``test_sharded_train_step_matches_single_device``
(``tests/test_distributed.py``), on a 2x4 gloo world of CPU ranks.

qwen2-moe-a2.7b smoke with two periods, one 8x32 batch: the JAX package's
weights cross as numpy (``interop.params_from_numpy``); on every rank the
params and the batch are placed by ``launch/shardings`` and the default
rules, and ``lm_loss`` runs under them, every contraction through the
mesh route.  The mesh loss is within 2e-3 of the port's single-process
loss (the reference test's own bound), on both backends (``torch``, and
``kernel`` with ``strategy="native"``, its plain version on the CPU);
the single-process loss equals the JAX package's within 1e-4, the
tolerance of the earlier slices' model tests.  With ``moe_impl="a2a"``
the mesh runs the expert all-to-all, and at a capacity factor where no
token drops its loss is within 2e-3 of the single-process (GShard) loss.

int8 gradient compression under the rules (minicpm-2b smoke, two
periods): the sharded step's gradient, compressed with its residual placed
as the parameters, is within one ulp of the JAX package's
``Int8Compressor`` on the same gradient and residual (its blocks run over
each leaf flattened whole), and ``Trainer(rules=)`` with
``compression="int8"`` gives the single-process int8 trainer's losses and
parameters; its residual is placed as the parameters and a sharded
checkpoint restores it bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro.distributed.compress import Int8Compressor as JInt8Compressor
from repro_torch.interop import params_from_numpy
from repro_torch.models.transformer import init_params, lm_loss
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
BACKENDS = {"torch": {}, "kernel": {"contract_backend": "kernel",
                                    "contract_strategy": "native"}}


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 4), ("data", "model"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH, smoke=True).with_(n_periods=2)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    jloss = float(jtransformer.lm_loss(jcfg, jp, {"tokens": jnp.asarray(toks)})[0])
    return jax.tree.map(np.asarray, jp), {"tokens": toks}, jloss


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_train_step_matches_single_device(world, weights, backend):
    np_params, batch, jloss = weights
    cfg = get_config(ARCH, smoke=True).with_(n_periods=2, **BACKENDS[backend])
    single = float(lm_loss(cfg, params_from_numpy(cfg, np_params, "cpu"),
                           {"tokens": torch.from_numpy(batch["tokens"])})[0])
    assert single == pytest.approx(jloss, rel=1e-4)
    mesh = world.run(torch_world.sharded_loss, ARCH, dict(n_periods=2, **BACKENDS[backend]),
                     np_params, batch)
    assert len(set(mesh)) == 1, mesh                      # every rank the same loss
    assert abs(mesh[0] - single) < 2e-3, (mesh[0], single)


def test_a2a_moe_under_rules_matches_single_process(world, weights):
    """``moe_impl="a2a"`` under rules no longer raises: it runs the expert
    all-to-all (``distributed/moe_a2a``) on the mesh.  At a capacity
    factor where no token drops it computes what the single-process
    GShard path computes: the mesh loss within the reference test's 2e-3
    of the single-process loss, on both backends."""
    np_params, batch, _ = weights
    for backend in sorted(BACKENDS):
        over = dict(n_periods=2, moe_impl="a2a", moe=_no_drop(), **BACKENDS[backend])
        cfg = get_config(ARCH, smoke=True).with_(**over)
        single = float(lm_loss(cfg, params_from_numpy(cfg, np_params, "cpu"),
                               {"tokens": torch.from_numpy(batch["tokens"])})[0])
        mesh = world.run(torch_world.sharded_loss, ARCH, over, np_params, batch)
        assert len(set(mesh)) == 1, mesh
        assert abs(mesh[0] - single) < 2e-3, (backend, mesh[0], single)


def _no_drop():
    """The smoke MoE at a capacity factor where no token drops, in either
    the GShard or the a2a path, on this test's batch."""
    m = get_config(ARCH, smoke=True).moe
    return dataclasses.replace(m, capacity_factor=64.0)


def test_tuned_strategy_raises_under_a_mesh(world, weights):
    np_params, batch, _ = weights
    with pytest.raises(torch_world.RankError, match="tuned"):
        world.run(torch_world.sharded_loss, ARCH,
                  dict(n_periods=2, contract_strategy="tuned"), np_params, batch)


INT8_ARCH = "minicpm-2b"
INT8_OPT = {"lr": 1e-3, "warmup_steps": 1}


def _int8_setup():
    over = dict(n_periods=2)
    cfg = get_config(INT8_ARCH, smoke=True).with_(**over)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    data = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0)
    return over, cfg, params, tree_map(lambda t: t.numpy(), params), data


def test_sharded_int8_compression_equals_the_jax_packages(world):
    """The sharded step's gradient, int8-compressed over the global leaves'
    256-element blocks with a residual placed as the parameters: every
    compressed and residual leaf is placed as its parameter, and both are
    within 1 ulp of the JAX ``Int8Compressor`` on the same gradient and
    residual (the tolerance of the unsharded comparison in
    ``test_torch_training.py``)."""
    over, _, params, np_params, data = _int8_setup()
    rng = np.random.default_rng(1)
    residual = [(rng.standard_normal(p.shape) * 1e-3).astype(np.float32)
                for p in tree_leaves(params)]
    batch = next(SyntheticLM(**data))
    got = world.run(torch_world.sharded_int8, INT8_ARCH, over, np_params, batch, residual)
    for r in got:
        assert r["placed"]
        jdeq, jres = JInt8Compressor().compress([jnp.asarray(g) for g in r["grads"]],
                                                [jnp.asarray(x) for x in residual])
        for t, j in zip(r["deq"] + r["res"], list(jdeq) + list(jres)):
            j = np.asarray(j)
            ulp = np.spacing(np.maximum(np.abs(t), np.abs(j)).astype(np.float32))
            assert np.all(np.abs(t - j) <= ulp)
    for r in got[1:]:      # every rank holds the same global values
        for a, b in zip(r["deq"] + r["res"], got[0]["deq"] + got[0]["res"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_int8_step_matches_unsharded(world, tmp_path):
    """``Trainer(rules=)`` with ``compression="int8"`` takes 2 steps: its
    losses within 2e-3 of the single-process int8 trainer's (the sharded
    trainer's bound) and its parameters within 1e-4 of them (the sharded
    gradient's summation order moves a few elements by ~2e-5; one quantised
    a step apart would move by ~lr, 1e-3); its residual is placed as the
    parameters, and a sharded checkpoint of it restores bit-equal."""
    over, cfg, params, np_params, data = _int8_setup()
    tr = Trainer(cfg, TrainConfig(opt=AdamWConfig(**INT8_OPT), compression="int8"), params,
                 SyntheticLM(**data))
    want = [h["loss"] for h in tr.run(2)]
    train = {"opt": INT8_OPT, "compression": "int8"}
    got = world.run(torch_world.sharded_train, INT8_ARCH, over, np_params, data, dict(train), 2,
                    str(tmp_path))
    again = world.run(torch_world.sharded_train, INT8_ARCH, over, np_params, data, dict(train),
                      0, str(tmp_path), True)
    for r, r2 in zip(got, again):
        assert r["step"] == 2 and r2["step"] == 2
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=2e-3)
        for mine, p in zip(r["params"], tree_leaves(tr.params)):
            np.testing.assert_allclose(mine, p.numpy(), rtol=0, atol=1e-4)
        assert r["residual_placements"] == r["placements"]
        assert r2["residual_placements"] == r["placements"]
        assert len(r2["residual"]) == len(r["residual"]) > 0
        for a, b in zip(r["residual"], r2["residual"]):
            np.testing.assert_array_equal(a, b)
