"""The language-model loss under sharding rules is vocab-parallel.

``lm_loss`` takes each position's negative log-likelihood through
``models.layers.token_nll``: on a DTensor every rank works on its own
block of the vocab (max and sum of exponentials all-reduced over the mesh
dims that shard it, the target's logit from the rank that holds it), so
no rank builds the logits or their gradient at the vocab's full width.

On a 2x4 gloo world (``data`` x ``model``), smoke widths (vocab 256),
the JAX package's weights carried over: the mesh loss is within 2e-3 of
the port's single-process loss and every gradient within 1e-4 of the
largest of its leaf (the sharded trainer tests' bounds), and the
single-process loss is within ``rel=1e-4`` of the JAX package's
``lm_loss``, every gradient within 1e-4 of ``jax.value_and_grad``'s (the
training tests' bound).  Cases: minicpm-2b with and without a mask,
gemma2-27b (``final_softcap`` 30) with and without a mask, and
hubert-xlarge (targets from ``labels``); layouts: the vocab sharded 4
ways over ``model`` (the default rules), sharded 8 ways over both axes,
and whole on every rank.  On a 1x1 world the step equals the unsharded
step bit for bit.
"""

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
from repro_torch.models.layers import token_nll
from repro_torch.models.tree import tree_leaves
from repro_torch.training.trainer import value_and_grad

torch.set_num_threads(1)

OVER = {"n_periods": 1}
#: name -> (arch, whether the batch has a mask)
CASES = {
    "minicpm": ("minicpm-2b", False),
    "minicpm_mask": ("minicpm-2b", True),
    "gemma2_softcap": ("gemma2-27b", False),
    "gemma2_softcap_mask": ("gemma2-27b", True),
    "hubert_labels": ("hubert-xlarge", False),
}
#: name -> (rules overrides, the logits' PartitionSpec on the 2x4 mesh,
#: the width of a rank's vocab block)
LAYOUTS = {
    "vocab_over_model": (None, ("data", None, "model"), 64),
    "vocab_over_both": ({"batch": None, "vocab": ("data", "model")},
                        (None, None, ("data", "model")), 32),
    "vocab_whole": ({"vocab": None}, ("data",), 256),
}
TOL = 1e-4      # single process against the JAX package
MESH_TOL = 2e-3  # mesh loss against single process


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 4), ("data", "model"))
    yield w
    w.close()


def _batch(cfg, mask: bool, B=8, S=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend is not None:
        batch["features"] = rng.standard_normal(
            (B, S, cfg.frontend.feature_dim)).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return batch


_REF = {}


def _reference(case):
    """The JAX package's loss and gradients and the port's single-process
    ones on the same weights and batch, once per case."""
    if case not in _REF:
        arch, mask = CASES[case]
        jcfg = jget_config(arch, smoke=True).with_(**OVER)
        cfg = get_config(arch, smoke=True).with_(**OVER)
        jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
        batch = _batch(cfg, mask)
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jtransformer.lm_loss(jcfg, p, b)[0]))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        np_params = jax.tree.map(np.asarray, jp)
        params = params_from_numpy(cfg, np_params, "cpu")
        loss, _, grads = value_and_grad(cfg, params,
                                        {k: torch.from_numpy(v) for k, v in batch.items()})
        _REF[case] = dict(np_params=np_params, batch=batch, jloss=float(jloss),
                          jgrads=[np.asarray(g) for g in jax.tree.leaves(jg)],
                          loss=float(loss), grads=[g.numpy() for g in tree_leaves(grads)])
    return _REF[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_process_loss_and_grads_match_jax(case):
    ref = _reference(case)
    assert ref["loss"] == pytest.approx(ref["jloss"], rel=TOL)
    assert len(ref["grads"]) == len(ref["jgrads"])
    for g, j in zip(ref["grads"], ref["jgrads"]):
        scale = max(1.0, float(np.abs(j).max()))
        assert float(np.abs(g - j).max()) <= TOL * scale


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_grads_match_single_process(world, case, layout):
    ref = _reference(case)
    rules, spec, block = LAYOUTS[layout]
    got = world.run(torch_world.vocab_loss, CASES[case][0], OVER, ref["np_params"],
                    ref["batch"], rules)
    for r in got:
        assert r["spec"] == spec and r["vocab_block"] == block
        assert r["loss"] == got[0]["loss"]                  # every rank the same loss
        assert abs(r["loss"] - ref["loss"]) < MESH_TOL, (r["loss"], ref["loss"])
        assert r["loss"] == pytest.approx(ref["jloss"], abs=MESH_TOL)
        for mine, g in zip(r["grads"], ref["grads"]):
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(mine, g, rtol=0, atol=TOL * max(scale, 1e-30))


def test_one_rank_mesh_equals_the_unsharded_step_bit_for_bit():
    """A 1x1 mesh runs the same arithmetic on its one block, with no
    collective: the loss and every gradient equal the unsharded step's."""
    ref = _reference("gemma2_softcap_mask")
    w = torch_world.World((1, 1), ("data", "model"))
    try:
        (r,) = w.run(torch_world.vocab_loss, "gemma2-27b", OVER, ref["np_params"], ref["batch"])
    finally:
        w.close()
    assert r["vocab_block"] == 256
    assert r["loss"] == ref["loss"]
    for mine, g in zip(r["grads"], ref["grads"]):
        np.testing.assert_array_equal(mine, g)


def test_token_nll_equals_log_softmax_and_gather():
    """On a plain tensor ``token_nll`` is ``-log_softmax`` at the target,
    and so is its gradient (``softmax - onehot``)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5, 40)).astype(np.float32) * 4)
    t = torch.from_numpy(rng.integers(0, 40, (3, 5)))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = token_nll(a, t)
    want = -torch.gather(torch.log_softmax(b, -1), -1, t[..., None])[..., 0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    (ga,), (gb,) = torch.autograd.grad(got, a, w), torch.autograd.grad(want, b, w)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)

