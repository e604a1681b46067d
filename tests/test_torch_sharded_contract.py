"""The port's sharded contraction on a 2x4 gloo world of CPU ranks, held
against the JAX package.

The cases of ``tests/test_sharded_contract.py`` (all but the serving one):
the three sharding regimes (batch-sharded / contracted-mode-sharded /
replicated), the ``out_spec`` resharding paths (reduce-scatter, all-gather,
local slice), every Table II case sharded, shard-aware ``make_plan`` and
path costing.  Results run on the ranks (``torch_world.World``: one gloo
world for this file, spawned once) and are compared with the JAX
package's single-device ``jnp.einsum`` / ``xeinsum`` on the same numpy
operands, atol and rtol 1e-4 as in the reference.  Plans are pure Python
and run in this process on a 2x4 ``DeviceMesh`` of torch's fake process
group, against the JAX package's planners on a stand-in mesh (axis names
and a device array of the mesh's shape), which need no devices.
"""

import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import torch_world
from repro.core.einsum import contraction_path as jcontraction_path
from repro.core.einsum import xeinsum as jxeinsum
from repro.core.planner import make_plan as jmake_plan
from repro.core.table2 import CASES
from repro.distributed import contract as jdc
from repro_torch.core.contract import contract
from repro_torch.core.einsum import contraction_path, xeinsum
from repro_torch.core.planner import make_plan, sharded_step_cost
from repro_torch.distributed.contract import plan_sharded, resolve_mode_axes, sharded_contract
from repro_torch.distributed.sharding import P, specs_equal

torch.set_num_threads(1)

#: the JAX package's planners need only the mesh's axis names and shape
JMESH = types.SimpleNamespace(axis_names=("x", "y"), devices=np.empty((2, 4), object))


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 4), ("x", "y"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def mesh():
    """A 2x4 ``DeviceMesh`` in this process, over torch's fake process
    group: enough to plan and to reject, never to communicate."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("x", "y"))
    finally:
        dist.destroy_process_group()


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jspecs(specs):
    if specs is None:
        return None
    return tuple(None if s is None else JP(*s) for s in specs)


def run(world, entry, spec, operands, **kw) -> dict:
    """``entry`` on every rank; every rank's global result must be the
    same.  Returns rank 0's record (see ``torch_world.call``)."""
    res = world.run(torch_world.call, entry, spec, list(operands), kw)
    for r in res[1:]:
        np.testing.assert_array_equal(r["full"], res[0]["full"])
        assert r["spec"] == res[0]["spec"]
    return res[0]


def assert_matches(world, spec, operands, in_specs, out_spec=None, **kw):
    ref = np.asarray(jnp.einsum(spec, *operands))
    got = run(world, "sharded_contract", spec, operands, in_specs=in_specs,
              out_spec=out_spec, **kw)
    np.testing.assert_allclose(got["full"], ref, atol=1e-4, rtol=1e-4)
    return got


# ------------------------------------------------------------ regimes
def test_batch_sharded_no_collectives(world, mesh):
    """Sharding the strided-batch mode is embarrassingly parallel."""
    A, B = rand((8, 4, 6), 0), rand((8, 6, 4), 1)
    plan = plan_sharded(
        "bmk,bkn->bmn", {"b": 8, "m": 4, "k": 6, "n": 4},
        mesh=mesh, in_specs=(P("y"), P("y")),
    )
    assert not plan.has_communication
    got = assert_matches(world, "bmk,bkn->bmn", (A, B), (P("y"), P("y")))
    assert specs_equal(P(*got["spec"]), P("y"))
    assert got["local_shape"] == (2, 4, 4)


def test_contracted_mode_sharded_psum(world, mesh):
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    plan = plan_sharded(
        "mk,kn->mn", {"m": 8, "k": 12, "n": 16},
        mesh=mesh, in_specs=(P("x", "y"), P("y", None)),
    )
    assert plan.psum_axes == ("y",)
    assert_matches(world, "mk,kn->mn", (A, B), (P("x", "y"), P("y", None)))


def test_contracted_sharded_one_operand_slices_locally(world, mesh):
    """k sharded in A only: B is sliced per shard — zero bytes moved."""
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    plan = plan_sharded(
        "mk,kn->mn", {"m": 8, "k": 12, "n": 16},
        mesh=mesh, in_specs=(P("x", "y"), P(None, None)),
    )
    assert plan.slice_b and plan.psum_axes == ("y",)
    assert_matches(world, "mk,kn->mn", (A, B), (P("x", "y"), P(None, None)))


def test_reduce_scatter_when_out_spec_shards_reduced_axis(world, mesh):
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    plan = plan_sharded(
        "mk,kn->mn", {"m": 8, "k": 12, "n": 16},
        mesh=mesh, in_specs=(P("x", "y"), P("y", None)), out_spec=P("x", "y"),
    )
    assert plan.scatters == ((1, ("y",)),) and not plan.psum_axes
    got = assert_matches(
        world, "mk,kn->mn", (A, B), (P("x", "y"), P("y", None)), out_spec=P("x", "y"),
    )
    assert specs_equal(P(*got["spec"]), P("x", "y"))
    assert got["local_shape"] == (4, 4)


def test_replicated_everywhere(world, mesh):
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    plan = plan_sharded(
        "mk,kn->mn", {"m": 8, "k": 12, "n": 16},
        mesh=mesh, in_specs=(P(None, None), P(None, None)),
    )
    assert not plan.has_communication
    assert_matches(world, "mk,kn->mn", (A, B), (P(None, None), P(None, None)))
    assert_matches(world, "mk,kn->mn", (A, B), None)  # in_specs=None alias


def test_all_gather_to_replicated_output(world):
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    got = assert_matches(
        world, "mk,kn->mn", (A, B), (P("x", None), P(None, "y")), out_spec=P(None, None),
    )
    assert specs_equal(P(*got["spec"]), P(None, None))
    assert got["local_shape"] == (8, 16)


def test_local_slice_to_freshly_sharded_output(world, mesh):
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    plan = plan_sharded(
        "mk,kn->mn", {"m": 8, "k": 12, "n": 16},
        mesh=mesh, in_specs=(P(None, None), P(None, None)),
        out_spec=P(None, "y"),
    )
    assert plan.slice_out and not plan.has_communication
    got = assert_matches(
        world, "mk,kn->mn", (A, B), (P(None, None), P(None, None)), out_spec=P(None, "y"),
    )
    assert specs_equal(P(*got["spec"]), P(None, "y"))


def test_full_reshard_gather_then_slice(world):
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    got = assert_matches(
        world, "mk,kn->mn", (A, B), (P("x", None), P(None, None)), out_spec=P("y", None),
    )
    assert specs_equal(P(*got["spec"]), P("y", None))  # modulo trailing None


def test_tuple_axis_group_batch(world):
    A, B = rand((8, 4, 6), 0), rand((6, 4), 1)
    got = assert_matches(
        world, "bmk,kn->bmn", (A, B), (P(("x", "y"), None, None), P(None, None))
    )
    assert specs_equal(P(*got["spec"]), P(("x", "y")))
    assert got["local_shape"] == (1, 4, 4)


def test_kernel_backend_local_kernels(world):
    """Each shard runs the port's kernel backend on its local block (its
    plain version here, on CPU tensors)."""
    A, B = rand((8, 8), 0), rand((4, 8, 8), 1)
    assert_matches(
        world, "mk,pkn->pmn", (A, B), (P(None, None), P("y", None, None)),
        strategy="batched", backend="kernel",
    )


@pytest.mark.parametrize("spec, shapes, in_specs, out_spec, collective", [
    ("mkl,kln->mn", ((8, 4, 8), (4, 8, 8)), (P(None, "x", "y"), P("x", "y", None)), None,
     "psum"),
    ("mk,kn->mn", ((8, 16), (16, 8)), (P(None, ("x", "y")), P(("x", "y"), None)),
     P(("x", "y"), None), "scatters"),
    ("mk,kn->mn", ((8, 16), (16, 8)), (P(("x", "y"), None), P(None, None)), P(None, None),
     "gathers"),
], ids=["psum", "reduce_scatter", "all_gather"])
def test_tuple_axis_group_collectives(spec, shapes, in_specs, out_spec, collective, world,
                                      mesh):
    """A collective over both mesh axes at once runs on the group built for
    ``("x", "y")``, its ranks outer axis major."""
    A, B = rand(shapes[0], 0), rand(shapes[1], 1)
    a, rest = spec.split(",")
    b = rest.split("->")[0]
    dims = dict(zip(a, shapes[0])) | dict(zip(b, shapes[1]))
    plan = plan_sharded(spec, dims, mesh=mesh, in_specs=in_specs, out_spec=out_spec)
    want = {"psum": ("psum_axes", ("x", "y")), "scatters": ("scatters", ((0, ("x", "y")),)),
            "gathers": ("gathers", ((0, ("x", "y")),))}[collective]
    assert getattr(plan, want[0]) == want[1]
    got = assert_matches(world, spec, (A, B), in_specs, out_spec=out_spec)
    assert specs_equal(P(*got["spec"]), plan.out_spec)


# ------------------------------------------------------------ validation
def test_conflicting_mode_sharding_raises(mesh):
    with pytest.raises(ValueError, match="shards both"):
        resolve_mode_axes(("mk", "kn"), (P("x", None), P("x", None)), mesh=mesh)


def test_inconsistent_shared_mode_raises(mesh):
    with pytest.raises(ValueError, match="identically"):
        resolve_mode_axes(("mk", "kn"), (P(None, "x"), P("y", None)), mesh=mesh)


def test_indivisible_dim_raises(mesh):
    with pytest.raises(ValueError, match="not divisible"):
        sharded_contract(
            "mk,kn->mn", torch.zeros(9, 12), torch.zeros(12, 16),
            mesh=mesh, in_specs=(P("x", None), P(None, None)),
        )


def test_unknown_mesh_axis_raises(mesh):
    with pytest.raises(ValueError, match="not in mesh"):
        sharded_contract(
            "mk,kn->mn", torch.zeros(8, 12), torch.zeros(12, 16),
            mesh=mesh, in_specs=(P("zz", None), P(None, None)),
        )


def test_tuned_strategy_rejected(mesh):
    with pytest.raises(ValueError, match="single-device"):
        sharded_contract(
            "mk,kn->mn", torch.zeros(8, 12), torch.zeros(12, 16),
            mesh=mesh, in_specs=None, strategy="tuned",
        )
    with pytest.raises(ValueError, match="single-device"):
        xeinsum(
            "mk,kn->mn", torch.zeros(8, 12), torch.zeros(12, 16),
            mesh=mesh, strategy="tuned",
        )


def test_out_spec_without_mesh_raises():
    with pytest.raises(ValueError, match="require mesh"):
        contract("mk,kn->mn", torch.zeros(8, 12), torch.zeros(12, 16), out_spec=P())


# ------------------------------------------------------------ Table II
def _table2_operands(label):
    """The reference's shapes and sharding for one Table II case; its seed
    is the label's CRC (the reference's ``hash(label)`` changes with every
    process)."""
    spec = CASES[label].row_major()
    a_modes, rest = spec.split(",")
    b_modes, _ = rest.split("->")
    dims = {"m": 8, "n": 8, "p": 8, "k": 8}
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    A = rng.standard_normal([dims[m] for m in a_modes]).astype(np.float32)
    B = rng.standard_normal([dims[m] for m in b_modes]).astype(np.float32)
    # shard m over x (free/batch coverage) and k over y (contracted
    # coverage) wherever each operand carries the mode
    shard = {"m": "x", "k": "y"}
    in_specs = (
        P(*[shard.get(m) for m in a_modes]),
        P(*[shard.get(m) for m in b_modes]),
    )
    return spec, dims, A, B, in_specs


@pytest.mark.parametrize("label", sorted(CASES))
def test_table2_case_sharded_matches_single_device(label, world):
    """Acceptance bar: every Table II case, sharded == single-device."""
    spec, _, A, B, in_specs = _table2_operands(label)
    single = np.asarray(jxeinsum(spec, jnp.asarray(A), jnp.asarray(B)))
    sharded = run(world, "xeinsum", spec, (A, B), in_specs=in_specs)
    np.testing.assert_allclose(sharded["full"], single, atol=1e-4, rtol=1e-4)


# ------------------------------------------------ plans against the JAX package
REGIME_PLANS = [
    ("bmk,bkn->bmn", {"b": 8, "m": 4, "k": 6, "n": 4}, (P("y"), P("y")), None),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P("x", "y"), P("y", None)), None),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P("x", "y"), P(None, None)), None),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P("x", "y"), P("y", None)), P("x", "y")),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P(None, None), P(None, None)), None),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P("x", None), P(None, "y")), P(None, None)),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P(None, None), P(None, None)), P(None, "y")),
    ("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, (P("x", None), P(None, None)), P("y", None)),
    ("bmk,kn->bmn", {"b": 8, "m": 4, "k": 6, "n": 4},
     (P(("x", "y"), None, None), P(None, None)), None),
    ("mk,pkn->pmn", {"m": 8, "k": 8, "p": 4, "n": 8}, (P(None, None), P("y", None, None)), None),
]


def _plan_cases():
    for i, case in enumerate(REGIME_PLANS):
        yield pytest.param(case, id=f"regime{i}-{case[0]}")
    for label in sorted(CASES):
        spec, dims, _, _, in_specs = _table2_operands(label)
        yield pytest.param((spec, dims, in_specs, None), id=f"table2-{label}")


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_plan_sharded_collectives_match_jax(case, mesh):
    """Slices, scatters, psum axes, gathers, output slices, specs and
    ``describe()`` equal the JAX package's plan for the same request."""
    spec, dims, in_specs, out_spec = case
    mine = plan_sharded(spec, dims, mesh=mesh, in_specs=in_specs, out_spec=out_spec)
    ref = jdc.plan_sharded(spec, dims, mesh=JMESH, in_specs=jspecs(in_specs),
                           out_spec=None if out_spec is None else JP(*out_spec))
    for field in ("slice_a", "slice_b", "scatters", "psum_axes", "gathers", "slice_out",
                  "mode_axes", "out_axes"):
        assert getattr(mine, field) == getattr(ref, field), field
    for field in ("a_spec", "b_spec", "out_spec"):
        assert tuple(getattr(mine, field)) == tuple(getattr(ref, field)), field
    assert mine.describe() == ref.describe()
    assert mine.has_communication == ref.has_communication


def test_tuple_axis_group_order_matches_jax(world, monkeypatch):
    """A dim sharded over ``("x", "y")`` gives each rank the block the JAX
    package's ``_group_index`` gives it (outer axis major): through the
    port's view, through DTensor's ``distribute_tensor`` on the port's
    placements and in a sharded contraction's result."""
    blocks = world.run(torch_world.block_order, 8, ("x", "y"))
    sizes = dict(x=2, y=4)
    for b in blocks:
        coord = dict(zip(("x", "y"), b["coord"]))
        fake_lax = types.SimpleNamespace(axis_index=lambda ax: coord[ax],
                                         psum=lambda one, ax: one * sizes[ax])
        monkeypatch.setattr(jdc, "lax", fake_lax)
        idx = jdc._group_index(("x", "y"))
        assert b["view"] == b["dtensor"] == b["contract"] == [float(idx)], b
        assert b["full"] == [float(i) for i in range(8)]
    assert sorted(b["view"][0] for b in blocks) == [float(i) for i in range(8)]


def test_replicated_operand_block_is_a_view(world):
    """The local blocks a rank contracts are views of the global tensors
    (same storage), for a replicated operand and for one sliced to match
    another operand's sharded contracted mode."""
    for seen in world.run(torch_world.replicated_views):
        assert seen == [[True, True], [True, True]]


def test_dtensor_operands_are_redistributed(world):
    """DTensor operands whose placements differ from ``in_specs`` are
    redistributed first, as ``shard_map`` distributes either way."""
    A, B = rand((8, 12), 0), rand((12, 16), 1)
    ops = (("dtensor", A, P(None, "y")), ("dtensor", B, P("x", None)))
    got = run(world, "contract", "mk,kn->mn", ops, in_specs=(P("x", "y"), P("y", None)))
    np.testing.assert_allclose(got["full"], np.asarray(jnp.einsum("mk,kn->mn", A, B)),
                               atol=1e-4, rtol=1e-4)
    assert specs_equal(P(*got["spec"]), P("x"))


# ------------------------------------------------------ planner / paths
def test_make_plan_mesh_plans_local_dims(mesh):
    plan = make_plan(
        "mk,kn->mn", {"m": 8, "k": 12, "n": 16},
        mesh=mesh, in_specs=(P("x", "y"), P("y", None)),
    )
    assert plan.dims == {"m": 4, "k": 3, "n": 16}
    assert "sharded[" in plan.notes and "psum over ['k']" in plan.notes
    ref = jmake_plan("mk,kn->mn", {"m": 8, "k": 12, "n": 16}, mesh=JMESH,
                     in_specs=(JP("x", "y"), JP("y", None)))
    assert plan.describe() == ref.describe()


def test_sharded_step_cost_model():
    dims = {"m": 8, "k": 12, "n": 16}
    flops, comm = sharded_step_cost(
        "mk,kn->mn", dims, {"m": "x", "k": "y"}, {"x": 2, "y": 4}
    )
    assert flops == 2 * 8 * 12 * 16 // 8      # both axes divide the work
    assert comm == 2 * 3 * (8 * 16 // 2) * 4  # ring psum of the local block
    # unsharded degrades to the plain flop model with zero comm
    assert sharded_step_cost("mk,kn->mn", dims, {}, {}) == (2 * 8 * 12 * 16, 0)


def test_path_optimizer_prefers_cheaper_collectives(mesh):
    """Equal-flop orders: the optimizer picks the one psum-ing fewer bytes.

    ``ab,bc,cd->ad`` with b sharded and a=d=4, b=c=16: both orders cost
    identical flops, but reducing after ``ab·bc`` psums the (a,c) block
    while reducing after ``ab·(bc·cd)`` psums only (a,d) — 4× smaller.
    The port's paths equal the JAX package's step for step.
    """
    shapes = ((4, 16), (16, 16), (16, 4))
    in_specs = (P(None, "y"), P("y", None), P(None, None))
    path = contraction_path(
        "ab,bc,cd->ad", *shapes, optimize="optimal",
        mesh=mesh, in_specs=in_specs,
    )
    assert path.steps[0].spec.spec_str() == "bc,cd->bd"
    naive = contraction_path(
        "ab,bc,cd->ad", *shapes, optimize="naive",
        mesh=mesh, in_specs=in_specs,
    )
    assert path.total_comm_bytes < naive.total_comm_bytes
    assert path.total_flops < naive.total_flops
    for mine, optimize in ((path, "optimal"), (naive, "naive")):
        ref = jcontraction_path("ab,bc,cd->ad", *shapes, optimize=optimize,
                                mesh=JMESH, in_specs=jspecs(in_specs))
        assert [(s.spec.spec_str(), s.flops, s.comm_bytes) for s in mine.steps] == \
            [(s.spec.spec_str(), s.flops, s.comm_bytes) for s in ref.steps]


def test_xeinsum_chain_sharded_matches(world):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 8, 12)).astype(np.float32)
    B = rng.standard_normal((12, 16)).astype(np.float32)
    C = rng.standard_normal((16, 8)).astype(np.float32)
    ref = np.asarray(jxeinsum("bik,kn,nj->bij", *map(jnp.asarray, (A, B, C))))
    in_specs = (P("x", None, "y"), P("y", None), P(None, None))
    got = run(world, "xeinsum", "bik,kn,nj->bij", (A, B, C), in_specs=in_specs)
    np.testing.assert_allclose(got["full"], ref, atol=1e-4, rtol=1e-4)
    # final-step out_spec lands the requested sharding
    gathered = run(world, "xeinsum", "bik,kn,nj->bij", (A, B, C), in_specs=in_specs,
                   out_spec=P(None, None, None))
    np.testing.assert_allclose(gathered["full"], ref, atol=1e-4, rtol=1e-4)
    assert specs_equal(P(*gathered["spec"]), P())
    # the compiled program the wrapper builds, called directly
    prog = run(world, "compile_program", "bik,kn,nj->bij", (A, B, C), in_specs=in_specs)
    np.testing.assert_array_equal(prog["full"], got["full"])


def test_sum_only_sharded_mode_rejected(mesh):
    A = torch.ones(4, 8)
    B = torch.ones(8, 4)
    with pytest.raises(NotImplementedError, match="summed out"):
        # mode 'z' appears once and not in the output, but is sharded
        xeinsum(
            "za,ab->b", A, B, mesh=mesh,
            in_specs=(P("x", None), P(None, None)),
        )
