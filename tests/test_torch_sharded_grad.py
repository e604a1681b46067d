"""Gradients through the port's sharded contraction on a 2x2 gloo world.

``sharded_contract`` runs one local product per rank and stitches the
result with collectives; under autograd each collective must carry its
dual backward.  The output reaches the collectives' backward as the
complete gradient of this rank's block (``DTensor.from_local``
redistributes it to the forward placements), so a psum's backward is the
identity, a reduce-scatter's an all-gather, and an all-gather's the
rank's own slice.  A DTensor operand declares its local gradient
``Partial`` along the plan's axes that do not split it.

Cases: psum, reduce-scatter, all-gather, and the last two over a tuple
group ``("x", "y")``; backends ``torch`` and ``kernel`` with
``strategy="native"`` (its plain version on the CPU); operands plain
tensors holding the global value, or DTensors.  The gradients of
``sum(C * W)`` with respect to the leaves, summed over the ranks, equal
the single-process gradients times the number of ranks that count each
element once: for a plain operand each rank's gradient is one term along
the plan's axes and a copy along the others, so the sum counts it once
per rank of the unused axes; for a DTensor operand each rank's gradient
is complete on the block it holds.  Within 2e-5 of the largest magnitude
for float32, exact for integer values.
"""

import math
import zlib

import numpy as np
import pytest
import torch

import torch_world
from repro_torch.distributed.sharding import P

torch.set_num_threads(1)

XY = ("x", "y")
SIZES = {"x": 2, "y": 2}

#: name -> (spec, A shape, B shape, in_specs, out_spec)
CASES = {
    "psum": ("ij,jk->ik", (6, 8), (8, 4), (P(None, "y"), P("y", None)), None),
    "reduce_scatter": ("ij,jk->ik", (6, 8), (8, 4), (P(None, "y"), P("y", None)),
                       P("y", None)),
    "all_gather": ("ij,jk->ik", (6, 8), (8, 4), (P("y", None), None), P(None, None)),
    "tuple_reduce_scatter": ("ij,jk->ik", (8, 8), (8, 4), (P(None, XY), P(XY, None)),
                             P(XY, None)),
    "tuple_all_gather": ("ij,jk->ik", (8, 8), (8, 4), (P(XY, None), None), P(None, None)),
}


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 2), XY)
    yield w
    w.close()


def _operands(shapes, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        return [rng.integers(-3, 4, size=s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _reference(spec, a, b, w):
    A = torch.from_numpy(a).requires_grad_(True)
    B = torch.from_numpy(b).requires_grad_(True)
    (torch.einsum(spec, A, B) * torch.from_numpy(w)).sum().backward()
    return A.grad.numpy(), B.grad.numpy()


def _unused_copies(in_specs, out_spec) -> int:
    used = set()
    for s in (*in_specs, out_spec):
        for e in s or ():
            used |= {e} if isinstance(e, str) else set(e or ())
    return math.prod(n for a, n in SIZES.items() if a not in used)


def _check(world, name, backend, integer, dtensor=False):
    spec, sa, sb, in_specs, out_spec = CASES[name]
    a, b, w = _operands((sa, sb, (sa[0], sb[1])), zlib.crc32(name.encode()), integer)
    ranks = world.run(torch_world.grad_case, spec, a, b, w, in_specs, out_spec, backend,
                      dtensor)
    for i, want in enumerate(_reference(spec, a, b, w)):
        assert all(r["grads"][i] is not None for r in ranks), f"operand {i} got no gradient"
        got = sum(r["grads"][i] for r in ranks)
        copies = (sum(r["masks"][i] for r in ranks) if dtensor
                  else _unused_copies(in_specs, out_spec))
        if integer:
            np.testing.assert_array_equal(got, want * copies)
        else:
            np.testing.assert_allclose(got, want * copies, rtol=0,
                                       atol=2e-5 * float(np.abs(want * copies).max()))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_contract_gradients_match_single_process(world, name, backend):
    _check(world, name, backend, integer=False)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dtensor_operand_gradients_match_single_process(world, name, backend):
    _check(world, name, backend, integer=False, dtensor=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_contract_gradients_exact_on_integers(world, name):
    _check(world, name, "kernel", integer=True)


def test_forward_without_autograd_keeps_in_place_collectives(world):
    """Without autograd the collectives run as before: the same result."""
    a, b = _operands(((6, 8), (8, 4)), 0, False)
    out = world.run(torch_world.call, "sharded_contract", "ij,jk->ik", [a, b],
                    dict(in_specs=(P(None, "y"), P("y", None)), out_spec=P("y", None)))
    for r in out:
        np.testing.assert_allclose(r["full"], a @ b, rtol=1e-5, atol=1e-5)
