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
from repro_torch.interop import params_from_numpy
from repro_torch.models.transformer import lm_loss

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
