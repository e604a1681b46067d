"""The port's GPipe stages (``repro_torch.distributed.pipeline``) on gloo
worlds of CPU ranks: a 4-rank ``pod`` axis and a 2x2 ``(pod, model)``
mesh, against the sequential run of the stages and the JAX package's
``pipeline_forward``.

The stage is ``tanh(x @ W[s])`` (``tests/test_distributed.py``'s
``test_pipeline_matches_sequential``), float32, rtol 1e-4.  The JAX side
runs in a subprocess with 4 simulated host devices; its output crosses
as numpy.  ``pipeline_loss``'s gradients with respect to the stacked
weights and the input equal the sequential run's (each rank's share
holds its stage's row and, on stage 0, the input's gradient), with
weights as plain tensors and as a DTensor over ``pod``, on both
backends.  On one stage (a world of one, in-process) output and
gradients are bit-identical to calling the stage on each microbatch.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import torch_world

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4

_JAX = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_forward

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4,), ("pod",))

def stage_fn(params, x, stage_idx):
    return jnp.tanh(x @ params["W"])

y = pipeline_forward(mesh, stage_fn, {"W": jnp.asarray(inp["W"])}, jnp.asarray(inp["x"]),
                     axis="pod")
np.save(sys.argv[2], np.asarray(y))
"""


def _inputs(n_stages: int, n_micro: int, micro: int = 2, d: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, micro, d)).astype(np.float32)
    c = rng.standard_normal((n_micro, micro, d)).astype(np.float32)
    return W, x, c


def _sequential(W, x, c=None):
    """The stages one after another on the whole input; with ``c`` also
    the gradients of ``sum(y * c)``."""
    Wt = torch.from_numpy(W).requires_grad_(c is not None)
    xt = torch.from_numpy(x).requires_grad_(c is not None)
    y = xt
    for s in range(W.shape[0]):
        y = torch.tanh(y @ Wt[s])
    if c is None:
        return y.detach().numpy()
    gw, gx = torch.autograd.grad((y * torch.from_numpy(c)).sum(), [Wt, xt])
    return y.detach().numpy(), gw.numpy(), gx.numpy()


@pytest.fixture(scope="module")
def world4():
    w = torch_world.World((4,), ("pod",))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world22():
    w = torch_world.World((2, 2), ("pod", "model"))
    yield w
    w.close()


def test_pipeline_matches_sequential(world4):
    W, x, _ = _inputs(4, 8)
    got = world4.run(torch_world.pipeline_case, W, x)
    for r in got:
        np.testing.assert_allclose(r["y"], _sequential(W, x), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["y"], got[0]["y"])


def test_pipeline_matches_jax(world4):
    W, x, _ = _inputs(4, 8)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npy")
        np.savez(src, W=W, x=x)
        proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX), src, dst],
                              capture_output=True, text=True, env=env, timeout=300,
                              stdin=subprocess.DEVNULL)
        assert proc.returncode == 0, proc.stderr[-4000:]
        want = np.load(dst)
    for r in world4.run(torch_world.pipeline_case, W, x):
        np.testing.assert_allclose(r["y"], want, rtol=TOL, atol=TOL)


def test_pipeline_on_a_pod_model_mesh(world22):
    """Two stages over ``pod``; the two ``model`` ranks of a stage do the
    same work."""
    W, x, _ = _inputs(2, 4)
    for r in world22.run(torch_world.pipeline_case, W, x):
        np.testing.assert_allclose(r["y"], _sequential(W, x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_pipeline_loss_gradients_match_sequential(world4, backend):
    W, x, c = _inputs(4, 6)
    y, gw, gx = _sequential(W, x, c)
    got = world4.run(torch_world.pipeline_case, W, x, c, backend)
    assert sorted(r["stage"] for r in got) == [0, 1, 2, 3]
    for r in got:
        assert r["loss"] == pytest.approx(float((y * c).sum()), rel=TOL)
        s = r["stage"]
        rows = np.zeros_like(gw)
        rows[s] = gw[s]  # a rank's share is its stage's row
        np.testing.assert_allclose(r["gw"], rows, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["gx"], gx if s == 0 else np.zeros_like(gx),
                                   rtol=TOL, atol=TOL)


def test_pipeline_loss_dtensor_weights_on_a_pod_model_mesh(world22):
    """Weights as a DTensor sharded over ``pod``: the gradient comes back
    whole on every rank."""
    W, x, c = _inputs(2, 4)
    _, gw, gx = _sequential(W, x, c)
    got = world22.run(torch_world.pipeline_case, W, x, c, "torch", True)
    for r in got:
        np.testing.assert_allclose(r["gw"], gw, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["gx"], gx if r["stage"] == 0 else np.zeros_like(gx),
                                   rtol=TOL, atol=TOL)


def test_too_few_microbatches_raises(world4):
    W, x, _ = _inputs(4, 3)
    with pytest.raises(torch_world.RankError, match="microbatches"):
        world4.run(torch_world.pipeline_case, W, x)


def test_one_stage_is_bit_identical_to_calling_the_stage():
    """A ``pod`` axis of one rank (a gloo world of one): no shift or sum
    is issued, the output is the stage called on each microbatch, and
    ``pipeline_loss``'s gradients are the sequential run's, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import pipeline_forward, pipeline_loss

    W, x, c = _inputs(1, 4)

    def stage_fn(params, xb, stage_idx):
        return torch.tanh(xb @ params["W"])

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        Wt = torch.from_numpy(W).requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        with torch.no_grad():
            y = pipeline_forward(mesh, stage_fn, {"W": Wt}, xt)
        want = torch.stack([stage_fn({"W": Wt[0]}, xt[i], 0) for i in range(4)])
        assert torch.equal(y, want)
        ct = torch.from_numpy(c)
        loss = pipeline_loss(mesh, stage_fn, {"W": Wt}, xt, ct, lambda y, t: (y * t).sum())
        got = torch.autograd.grad(loss, [Wt, xt])
        ref = torch.autograd.grad((want * ct).sum(), [Wt, xt])
        assert torch.equal(loss, (want * ct).sum())
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    finally:
        dist.destroy_process_group()
