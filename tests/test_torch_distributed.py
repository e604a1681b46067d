"""The port's sharding layer in this process, against the JAX package:
partition specs and their DTensor placements, the logical-axis rules,
mesh construction, the shard placement pass on a one-rank mesh, and the
planning code copied from the JAX package, pinned by syntax tree.

A test that needs a process group starts its own (a world of one over an
in-process store, or torch's fake group of eight ranks) and destroys it
before it returns.
"""

import ast
import contextlib
import inspect
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.core import planner as jplanner
from repro.distributed import contract as jdc
from repro.distributed import sharding as jsharding
from repro.launch import mesh as jmesh
from repro_torch.core import planner
from repro_torch.core.contract import contract
from repro_torch.core.program import ProgramOptions, build_program, compile_program
from repro_torch.distributed import contract as dc
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, specs_equal
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)


@contextlib.contextmanager
def world_of_one():
    """A gloo world of one rank, destroyed on exit."""
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- rules
def test_sharding_rules_dedup_and_missing_axes():
    """pod axis absent on this mesh -> dropped; duplicate mesh axis -> dropped."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        rules = sharding.ShardingRules(mesh)
        spec = rules.physical(("batch", "kv_seq", "kv_heads", None))
        assert spec == ("data", "model", None, None)
        assert repr(spec) == "PartitionSpec('data', 'model', None, None)"
        assert rules.sharding(("batch", "kv_seq", "kv_heads", None)) == (Shard(0), Shard(1))
        assert rules.sharding(("d_model", "ff")) == (Replicate(), Shard(1))
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((2, 4), object))
    ref = jsharding.ShardingRules(stand_in).physical(("batch", "kv_seq", "kv_heads", None))
    assert tuple(ref) == tuple(spec)


def test_logical_is_a_no_op_outside_rules_and_redistributes_inside():
    from torch.distributed.tensor import Replicate, Shard

    x = torch.arange(8.0).reshape(2, 4)
    assert sharding.logical(x, "batch", "ff") is x
    assert sharding.named_sharding(("batch", "ff")) is None
    with world_of_one() as mesh:
        rules = sharding.ShardingRules(mesh)
        with sharding.use_rules(rules):
            assert sharding.current_rules() is rules
            assert sharding.logical(x, "batch", "ff") is x  # a plain tensor stays
            dt = dc.as_dtensor(x, P(), mesh)
            got = sharding.logical(dt, "batch", "ff")
            assert tuple(got.placements) == (Shard(0), Shard(1))
            assert torch.equal(got.full_tensor(), x)
            assert sharding.named_sharding(("d_model", "ff")) == (Replicate(), Shard(1))
            with pytest.raises(ValueError, match="rank-2"):
                sharding.logical(x, "batch")
        assert sharding.current_rules() is None


@pytest.mark.parametrize("a, b", [
    (("y", None), ("y",)), ((), None), ((None, None), ()), (("x",), ("y",)),
    ((("x", "y"), None), (("x", "y"),)), (("x",), (None, "x")),
])
def test_specs_equal_matches_jax(a, b):
    mine = specs_equal(P(*a), None if b is None else P(*b))
    ref = jsharding.specs_equal(JP(*a), None if b is None else JP(*b))
    assert mine == ref


def test_placements_and_spec_round_trip():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("x", "y"))
        assert sharding.placements(P(None, "y"), mesh) == (Replicate(), Shard(1))
        assert sharding.placements(P(("x", "y")), mesh) == (Shard(0), Shard(0))
        with pytest.raises(NotImplementedError, match="mesh order"):
            sharding.placements(P(("y", "x")), mesh)
        with pytest.raises(ValueError, match="not in mesh"):
            sharding.placements(P("z"), mesh)
        for spec in (P("x", "y"), P(None, ("x", "y")), P("y"), P()):
            dt = DTensor.from_local(torch.zeros(1, 1), mesh,
                                    sharding.placements(spec, mesh), run_check=False)
            assert specs_equal(sharding.spec_of(dt), spec)


def test_partition_spec_pickles_and_normalises_lists():
    import pickle

    spec = P(["x", "y"], None)
    assert spec == (("x", "y"), None)
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert isinstance(pickle.loads(pickle.dumps(spec)), P)


# -------------------------------------------------------------- meshes
@pytest.mark.parametrize("arg", ["2x4", "1X8", "3x1", "2x", "0x4", "axb", "2x2x2"])
def test_parse_mesh_shape_matches_jax(arg):
    try:
        want = jmesh.parse_mesh_shape(arg)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tmesh.parse_mesh_shape(arg)
    else:
        assert tmesh.parse_mesh_shape(arg) == want


def test_make_host_mesh_world_of_one():
    with world_of_one() as mesh:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="world of 2 ranks"):
            tmesh.make_host_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="needs a world of 256"):
            tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="world of 8 ranks"):
        tmesh.make_host_mesh(2, 4, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tmesh.make_host_mesh(1, 1, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            tmesh.make_host_mesh(1, 1)
        assert not dist.is_initialized()


def test_make_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="needs a world of 512"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with fake_world(256):
        mesh = tmesh.make_production_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)


# ------------------------------------------------- the sharded path, one rank
def test_shard_placement_pass_annotates_pspecs():
    """On a 1-rank mesh the placement machinery runs end to end (specs
    thread through the DAG) without a multi-rank world."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.passes import (
        PassContext, PathOptimizationPass, ShardPlacementPass)

    A, B, C = (torch.from_numpy(_rand(i, s)) for i, s in enumerate(((4, 6), (6, 8), (8, 2))))
    with world_of_one():
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
        prog = build_program(
            {"A": A, "B": B, "C": C},
            [("out", "ab,bc,cd->ad", ("A", "B", "C"))],
        )
        ctx = PassContext(options=ProgramOptions(
            mesh=mesh, in_specs=(P("x", None), P(None, None), None), out_specs=(None,)))
        planned = PathOptimizationPass().run(prog, ctx)
        placed = ShardPlacementPass().run(planned, ctx)
        contracts = [s for s in placed.steps if s.op == "contract"]
        assert all(len(s.in_pspecs) == 2 for s in contracts)
        assert all(s.out_pspec is not None for s in contracts)
        got = compile_program(prog, mesh=mesh,
                              in_specs=(P("x", None), P(None, None), None))(A, B, C)
        np.testing.assert_allclose(
            got.full_tensor().numpy(),
            np.asarray(jnp.einsum("ab,bc,cd->ad", A.numpy(), B.numpy(), C.numpy())),
            rtol=1e-4, atol=1e-4,
        )


@pytest.mark.parametrize("spec, shapes, in_specs, out_spec", [
    ("mk,kn->mn", ((8, 12), (12, 16)), (P("data", "model"), P("model", None)), None),
    ("mk,kn->mn", ((8, 12), (12, 16)), (P(None, "model"), P("model", None)), P("model")),
    ("mnp,pr->mnr", ((6, 5, 7), (7, 3)), (P("data"), None), None),
    ("mnp,nr->mrp", ((6, 5, 7), (5, 3)), (None, P("model")), P(None, None, "data")),
])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_world_of_one_sharded_equals_unsharded(spec, shapes, in_specs, out_spec, backend):
    """On a 1x1 mesh every block is the whole tensor, so a sharded call
    equals the unsharded call bit for bit — the check the card's smoke run
    makes."""
    A, B = (torch.from_numpy(_rand(i, s)) for i, s in enumerate(shapes))
    with world_of_one() as mesh:
        got = contract(spec, A, B, mesh=mesh, in_specs=in_specs, out_spec=out_spec,
                       backend=backend)
        assert torch.equal(got.full_tensor(), contract(spec, A, B, backend=backend))
        assert torch.equal(got.to_local(), contract(spec, A, B, backend=backend))


def test_sharded_call_checks_mesh_and_devices():
    A = torch.zeros(4, 4)
    with world_of_one() as mesh:
        with pytest.raises(ValueError, match="nothing is moved"):
            contract("mk,kn->mn", A, torch.zeros(4, 4, device="meta"), mesh=mesh)
        with pytest.raises(TypeError, match="DeviceMesh"):
            compile_program("mk,kn->mn", A, A, mesh="mesh")
        with pytest.raises(ValueError, match="require mesh"):
            compile_program("mk,kn->mn", A, A, in_specs=(None, None))


def test_contract_span_records_sharded():
    from repro_torch.obs import trace

    A = torch.ones(4, 4)
    t = trace.enable_tracing(trace.Tracer())
    try:
        with world_of_one() as mesh:
            contract("mk,kn->mn", A, A, mesh=mesh, in_specs=(P("data"), None))
            contract("mk,kn->mn", A, A)
    finally:
        trace.disable_tracing()
    spans = sorted((e for e in t.events() if e["name"] == "contract"), key=lambda e: e["ts"])
    # the sharded call's span, the local call's inside it, the unsharded call's
    assert [e["args"]["sharded"] for e in spans] == [True, False, False]
    assert [e["depth"] for e in spans] == [0, 1, 0]


def test_program_cache_keeps_the_meshes_of_two_worlds_apart():
    """A world destroyed and started again with the same shape gives a mesh
    equal to the old one by value; the program cache must not hand back a
    program bound to the old mesh's destroyed groups."""
    from repro_torch.core.einsum import xeinsum

    A, B, C = (torch.from_numpy(_rand(i, s)) for i, s in enumerate(((4, 6), (6, 8), (8, 2))))
    ins = (P("data", None), P(None, "model"), None)
    want = xeinsum("ab,bc,cd->ad", A, B, C)
    meshes = []
    for _ in range(2):
        with world_of_one() as mesh:
            got = xeinsum("ab,bc,cd->ad", A, B, C, mesh=mesh, in_specs=ins)
            assert got.device_mesh is mesh
            assert torch.equal(got.full_tensor(), want)
            meshes.append(mesh)
    assert meshes[0] == meshes[1] and meshes[0] is not meshes[1]


def test_tuple_axis_groups_are_built_per_mesh():
    """A tuple axis group's process group belongs to its mesh: the mesh of a
    new world of the same shape gets its own."""
    pgs = []
    for _ in range(2):
        with world_of_one() as mesh:
            pg = dc._process_group(mesh, ("data", "model"))
            assert pg is dc._process_group(mesh, ("data", "model"))
            assert dist.get_world_size(pg) == 1
            pgs.append(pg)
    assert pgs[0] is not pgs[1]


# ----------------------------------------------- copies of the JAX package
_NAMES = {"mesh.axis_names": "mesh.mesh_dim_names", "mesh.devices.shape": "mesh.shape",
          ": Mesh": ": DeviceMesh"}


def _src(obj, names=_NAMES):
    """An object's source without docstrings, one statement per line, with
    the mesh API's names mapped to a ``DeviceMesh``'s."""
    tree = ast.parse(inspect.getsource(obj))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    text = ast.unparse(tree)
    for old, new in names.items():
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("name", ["_as_group", "_entry", "_mode_partition",
                                  "resolve_mode_axes", "_axis_sizes", "local_dims",
                                  "ShardedPlan", "plan_sharded"])
def test_sharded_planning_is_the_jax_packages(name):
    assert _src(getattr(dc, name)) == _src(getattr(jdc, name))


def test_sharded_step_cost_is_the_jax_packages():
    assert planner.COMM_FLOPS_PER_BYTE == jplanner.COMM_FLOPS_PER_BYTE == 32.0
    assert _src(planner.sharded_step_cost) == _src(jplanner.sharded_step_cost)
    dims = {"m": 8, "k": 12, "n": 16, "b": 4}
    for spec, axes in (("mk,kn->mn", {"m": "x", "k": "y"}), ("bmk,bkn->bmn", {"b": "x"}),
                       ("mk,kn->mn", {"k": ("x", "y")})):
        assert planner.sharded_step_cost(spec, dims, axes, {"x": 2, "y": 4}) == \
            jplanner.sharded_step_cost(spec, dims, axes, {"x": 2, "y": 4})
