"""The port's expert all-to-all (``repro_torch.distributed.moe_a2a``)
against the JAX package's ``moe_ffn_a2a``, on a 2x4 gloo world of CPU
ranks (and a world of one).

The JAX side runs in a subprocess with 8 simulated host devices (as
``tests/test_distributed.py`` runs its meshes) on the same numpy weights
and tokens; its results cross as numpy.  qwen2-moe-a2.7b smoke widths
(d_model 64, d_expert 32, top-2, swiglu), float32: forward within 1e-5,
gradients within 1e-4.  Both of the port's backends: ``torch``, and
``kernel`` with ``strategy="native"`` (its plain version on the CPU).

* 4 experts on 8 ranks (``Xloc`` 1): the port equals the JAX package at
  the default capacity factor, where tokens drop (the JAX output there
  differs from its output at a factor where none do); on a world of one
  against a 1x1 mesh, 4 tokens (``C2`` 2); and the gradients of ``x``,
  the router and the three expert stacks equal ``jax.grad``'s.  One
  token on one rank gives ``C2`` 0: the port drops every routed token
  (zeros), where the JAX package raises.
* 16 experts on 8 ranks (``Xloc`` 2): rank ``d`` holds experts ``j·8 +
  d``, so the port equals the JAX package fed the stack permuted that way
  (drops included), and equals GShard where nothing drops; the JAX
  package's own (unpermuted) layout does not equal GShard there, since it
  gives a token another expert's weights.
* With DTensor operands placed as a model places them, output and whole
  gradients equal the plain operands' summed shares, and a DTensor
  expert stack hands each rank its own experts ``w[d::8]`` alone.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from repro.distributed import moe_a2a as jmoe_a2a
from repro_torch.configs import get_config
from repro_torch.distributed.moe_a2a import _ranks_within_groups, pad_expert_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = {"torch": {}, "kernel": {"contract_backend": "kernel",
                                    "contract_strategy": "native"}}
NO_DROP = 64.0          # a capacity factor at which no token drops here
FWD, GRAD = 1e-5, 1e-4

_JAX = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.distributed.moe_a2a import moe_ffn_a2a
from repro.models.moe import moe_ffn

inp = dict(np.load(sys.argv[1]))
base = get_config("qwen2-moe-a2.7b", smoke=True)
devs = np.array(jax.devices())
mesh8 = jax.sharding.Mesh(devs.reshape(2, 4), ("data", "model"))
mesh1 = jax.sharding.Mesh(devs[:1].reshape(1, 1), ("data", "model"))

def cfg(X, cf):
    return base.with_(moe=dataclasses.replace(base.moe, n_experts=X, n_shared=0,
                                              capacity_factor=cf))

def params(X, permuted=False):
    p = {k: jnp.asarray(inp[f"p{X}_{k}"]) for k in ("router", "wi", "wg", "wo")}
    if permuted:  # block d of the stack = experts j*8 + d
        for k in ("wi", "wg", "wo"):
            w = p[k]
            p[k] = w.reshape((X // 8, 8) + w.shape[1:]).swapaxes(0, 1).reshape(w.shape)
    return p

def a2a(X, cf, x, mesh=mesh8, permuted=False):
    fn = jax.jit(lambda p, x: moe_ffn_a2a(cfg(X, cf), p, x, mesh))
    with mesh:
        return np.asarray(fn(params(X, permuted), jnp.asarray(x)))

x, x1, c = inp["x"], inp["x1"], inp["c"]
out = {
    "drop": a2a(4, 1.25, x), "nodrop": a2a(4, %(nd)r, x),
    "one": a2a(4, 1.25, x1, mesh1),
}
try:  # one token: C2 = 0
    a2a(4, 1.25, x1[:, :1], mesh1)
    out["c2zero_error"] = np.array("")
except TypeError as e:
    out["c2zero_error"] = np.array(str(e))
out |= {
    "perm16": a2a(16, 1.25, x, permuted=True),
    "unperm16": a2a(16, %(nd)r, x),
    "gshard16": np.asarray(jax.jit(lambda p, x: moe_ffn(cfg(16, %(nd)r), p, x)[0])(
        params(16), jnp.asarray(x))),
}

def loss(p, x):
    return jnp.sum(moe_ffn_a2a(cfg(4, 1.25), p, x, mesh8) * c)

with jax.set_mesh(mesh8):
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params(4), jnp.asarray(x))
out["g_x"] = np.asarray(gx)
for k, v in gp.items():
    out["g_" + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _params(X: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    E, F = 64, 32
    return {"router": (rng.standard_normal((E, X)) * E**-0.5).astype(np.float32),
            "wi": (rng.standard_normal((X, E, F)) * E**-0.5).astype(np.float32),
            "wg": (rng.standard_normal((X, E, F)) * E**-0.5).astype(np.float32),
            "wo": (rng.standard_normal((X, F, E)) * F**-0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def case():
    """The numpy inputs and the JAX package's results on them."""
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((4, 16, 64)).astype(np.float32),
           "x1": rng.standard_normal((1, 4, 64)).astype(np.float32),
           "c": rng.standard_normal((4, 16, 64)).astype(np.float32)}
    p = {4: _params(4, 1), 16: _params(16, 2)}
    for X, tree in p.items():
        inp.update({f"p{X}_{k}": v for k, v in tree.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **inp)
        proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX % {"nd": NO_DROP}),
                               src, dst], capture_output=True, text=True, env=env,
                              timeout=300, stdin=subprocess.DEVNULL)
        assert proc.returncode == 0, proc.stderr[-4000:]
        jx = dict(np.load(dst))
    return inp, p, jx


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 4), ("data", "model"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world1():
    w = torch_world.World((1, 1), ("data", "model"))
    yield w
    w.close()


def _moe(X: int, cf: float) -> dict:
    m = get_config("qwen2-moe-a2.7b", smoke=True).moe
    return {"moe": dataclasses.replace(m, n_experts=X, n_shared=0, capacity_factor=cf)}


def _same_on_every_rank(results, key="y"):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


@pytest.mark.parametrize("n_devices", [1, 3, 4, 8])
def test_pad_expert_params_matches_jax(n_devices):
    p = _params(4, 3)
    got = pad_expert_params({k: torch.from_numpy(v) for k, v in p.items()}, n_devices)
    want = jmoe_a2a.pad_expert_params({k: jnp.asarray(v) for k, v in p.items()}, n_devices)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n_groups,n", [(1, 7), (3, 40), (8, 64), (9, 5)])
def test_ranks_within_groups_matches_jax(n_groups, n):
    groups = np.random.default_rng(n).integers(0, n_groups, n)
    order = np.argsort(groups, kind="stable")
    counts = np.bincount(groups, minlength=n_groups)
    starts = np.cumsum(counts) - counts
    got = _ranks_within_groups(*(torch.from_numpy(a) for a in (groups, order, starts)))
    want = jmoe_a2a._ranks_within_groups(*(jnp.asarray(a) for a in (groups, order, starts)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_layer_matches_jax_with_drops(world, case, backend):
    inp, p, jx = case
    assert np.abs(jx["drop"] - jx["nodrop"]).max() > 1e-2   # some tokens do drop
    got = world.run(torch_world.a2a_layer, {**_moe(4, 1.25), **BACKENDS[backend]}, p[4],
                    inp["x"])
    np.testing.assert_allclose(_same_on_every_rank(got), jx["drop"], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_layer_one_rank_matches_jax(world1, case, backend):
    """4 tokens on a 1x1 mesh: ``cap`` 11, ``C2 = 11 // 4 = 2``, so
    tokens drop at the experts (none can at the one destination)."""
    inp, p, jx = case
    (got,) = world1.run(torch_world.a2a_layer, {**_moe(4, 1.25), **BACKENDS[backend]}, p[4],
                        inp["x1"])
    np.testing.assert_allclose(got["y"], jx["one"], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_layer_one_rank_all_routed_tokens_drop(world1, case, backend):
    """One token on a 1x1 mesh: ``cap`` 3, ``C2 = 3 // 4 = 0``: no expert
    has a slot, every routed token drops and the output is zero.  The JAX
    package raises there instead (a gather from an empty expert buffer;
    ROADMAP.md queue 3)."""
    inp, p, jx = case
    assert "gather" in str(jx["c2zero_error"]), jx["c2zero_error"]
    (got,) = world1.run(torch_world.a2a_layer, {**_moe(4, 1.25), **BACKENDS[backend]}, p[4],
                        inp["x1"][:, :1])
    np.testing.assert_array_equal(got["y"], np.zeros_like(inp["x1"][:, :1]))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_expert_ownership_matches_permuted_jax(world, case, backend):
    inp, p, jx = case
    assert np.abs(jx["perm16"] - jx["gshard16"]).max() > 1e-2   # some tokens do drop
    got = world.run(torch_world.a2a_layer, {**_moe(16, 1.25), **BACKENDS[backend]}, p[16],
                    inp["x"])
    np.testing.assert_allclose(_same_on_every_rank(got), jx["perm16"], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_matches_gshard_without_drops(world, case, backend):
    inp, p, jx = case
    got = world.run(torch_world.a2a_layer, {**_moe(16, NO_DROP), **BACKENDS[backend]},
                    p[16], inp["x"])
    np.testing.assert_allclose(_same_on_every_rank(got), jx["gshard16"], rtol=FWD, atol=FWD)


def test_jax_unpermuted_experts_differ_from_gshard(case):
    """The JAX package's contiguous expert blocks with ``Xloc`` 2 give a
    token routed to expert ``e`` the weights of expert
    ``(e % 8)·2 + e // 8`` (ROADMAP.md queue 3)."""
    _, _, jx = case
    scale = np.abs(jx["gshard16"]).max()
    assert np.abs(jx["unperm16"] - jx["gshard16"]).max() > 0.1 * scale


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_a2a_layer_gradients_match_jax(world, case, backend):
    inp, p, jx = case
    got = world.run(torch_world.a2a_layer, {**_moe(4, 1.25), **BACKENDS[backend]}, p[4],
                    inp["x"], inp["c"])
    for name in ("x", "router", "wi", "wg", "wo"):
        mine = sum(r["grads"][name] for r in got)
        np.testing.assert_allclose(mine, jx["g_" + name], rtol=GRAD, atol=GRAD, err_msg=name)


@pytest.mark.parametrize("X", [4, 16])
def test_a2a_dtensor_operands_match_plain(world, case, X):
    """DTensor weights (experts over ``model``, their hidden width over
    ``data``) and tokens (rows over ``data``, sequence over ``model``):
    the same output and, gathered whole, the plain operands' summed
    gradient shares."""
    inp, p, _ = case
    over = _moe(X, 1.25)
    plain = world.run(torch_world.a2a_layer, over, p[X], inp["x"], inp["c"])
    placed = world.run(torch_world.a2a_layer, over, p[X], inp["x"], inp["c"], True)
    np.testing.assert_allclose(_same_on_every_rank(placed), plain[0]["y"], rtol=FWD, atol=FWD)
    for name in plain[0]["grads"]:
        want = sum(r["grads"][name] for r in plain)
        for r in placed:
            np.testing.assert_allclose(r["grads"][name], want, rtol=GRAD, atol=GRAD,
                                       err_msg=name)


@pytest.mark.parametrize("X", [4, 16, 60])
def test_a2a_dtensor_experts_reach_only_their_owner(world, X):
    """A DTensor expert stack (experts over ``model``, hidden width over
    ``data``; 60 splits unevenly over the 8 ranks) hands rank ``d`` its
    experts ``w[d::8]`` alone, cast to bfloat16 and padded with zero
    experts to ``Xloc`` (global rank ``d`` is flat rank ``d`` here)."""
    w = np.random.default_rng(X).standard_normal((X, 6, 8)).astype(np.float32)
    got = world.run(torch_world.a2a_owned, w)
    Xloc = -(-X // 8)
    padded = np.concatenate([w, np.zeros((Xloc * 8 - X, 6, 8), np.float32)])
    want = torch.from_numpy(padded).to(torch.bfloat16).float().numpy()
    for d, own in enumerate(got):
        np.testing.assert_array_equal(own, want[d::8], err_msg=f"rank {d}")
