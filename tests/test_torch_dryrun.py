"""The port's dry run (``repro_torch.launch.dryrun``), its cost counter
(``repro_torch.utils.CostCounter``) and its roofline
(``repro_torch.launch.roofline``), against the JAX package's.

The port traces a cell's step on fake tensors in a fake process group of
256 or 512 ranks, on ``device="cpu"`` here (the container's torch cannot
make fake CUDA tensors).  The JAX package's modules set ``XLA_FLAGS`` at
import, so they run in subprocesses: one reads its presets, skip rules,
perf cells and roofline rows; one compiles sharded contractions and an
expert all-to-all on 8 simulated host devices and reads their collective
bytes from the HLO.  The copies (``COLLECTIVES``, ``arch_preset``,
``shape_rules_overrides``, ``_skip_reason``, ``perf.CELLS``) are pinned by
syntax tree.  Every fake world is started and destroyed within its test.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, registry
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.distributed.moe_a2a import _bincount, _flat_blocks, owned_counts
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch import shardings as sh
from repro_torch.models.transformer import init_params
from repro_torch.models.tree import tree_leaves
from repro_torch.obs import roofline as obs_roofline
from repro_torch.training.data import make_batch_specs
from repro_torch.training.optimizer import adamw_init
from repro_torch.utils import CostCounter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LAUNCH = os.path.join(REPO, "src", "repro", "launch")


def _jax_env(devices: int) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")


def _start(code: str, devices: int) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], text=True,
                            env=_jax_env(devices), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, stdin=subprocess.DEVNULL)


def _result(proc: subprocess.Popen):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def smoke_config(arch, **kw):
    return registry.get_config(arch, smoke=True, **kw)


@pytest.fixture
def smoke(monkeypatch):
    """Cells at the smoke widths, as the JAX package's dry-run test runs
    them (``get_config`` patched to the smoke config)."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    monkeypatch.setattr(roofline, "get_config", smoke_config)


# ------------------------------------------------------ the JAX package's side
#: the cells whose roofline rows are compared: (arch, shape, multi_pod)
ROOF_CELLS = (("minicpm-2b", "train_4k", False), ("kimi-k2-1t-a32b", "train_4k", True),
              ("internlm2-20b", "decode_32k", False), ("granite-20b", "prefill_32k", False))


def _record(arch, shape, multi_pod, i):
    """A synthetic dry-run record (the numbers are arbitrary)."""
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "ok",
            "flops": 1.234e14 * (i + 1), "bytes_accessed": 5.6e12 / (i + 1),
            "fused_bytes_accessed": 7.8e10 * (i + 2),
            "collective_bytes": {"all-gather": 3_000_000_000 * i, "all-reduce": 17 + i,
                                 "reduce-scatter": 0, "all-to-all": 5 * 10**9,
                                 "collective-permute": 0}}


_JAX_SIDE = """
import dataclasses, json
from repro.configs import get_config, list_archs
from repro.configs.shapes import SHAPES, applicable_shapes
from repro.launch import dryrun, perf, roofline

out = {"cells": {}, "perf": perf.CELLS, "roofline": []}
for arch in list_archs():
    cfg = get_config(arch)
    p_cfg, opt = dryrun.arch_preset(cfg)
    app = applicable_shapes(cfg)
    for name, shape in SHAPES.items():
        out["cells"][arch + "/" + name] = {
            "param_dtype": p_cfg.param_dtype, "opt": dataclasses.asdict(opt),
            "overrides": dryrun.shape_rules_overrides(p_cfg, shape),
            "applicable": app[name] is not None,
            "skip": None if app[name] is not None else dryrun.dryrun_cell(arch, name),
        }
zero = {"flops": 0.0, "bytes": 0.0, "collective": 0}
for rec in %(records)r:
    out["roofline"].append(roofline.roofline_cell(rec["arch"], rec["shape"], rec, body=zero))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_procs():
    """Both of the JAX package's subprocesses, started together."""
    records = [_record(*c, i) for i, c in enumerate(ROOF_CELLS)]
    procs = {"side": _start(_JAX_SIDE % {"records": records}, devices=8),
             "collectives": _start(_JAX_COLLECTIVES % {"moe_shapes": MOE_SHAPES, "moe_x": MOE_X,
                                                       "pipe_w": PIPE_W, "pipe_x": PIPE_X},
                                   devices=8)}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def jax_side(jax_procs):
    return _result(jax_procs["side"])


def _port_cell(arch, name, shape):
    cfg = get_config(arch)
    p_cfg, opt = dryrun.arch_preset(cfg)
    app = applicable_shapes(cfg)
    return {"param_dtype": p_cfg.param_dtype, "opt": dataclasses.asdict(opt),
            "overrides": dryrun.shape_rules_overrides(p_cfg, shape),
            "applicable": app[name] is not None,
            "skip": None if app[name] is not None else dryrun.dryrun_cell(arch, name)}


@pytest.mark.parametrize("arch", list_archs())
def test_presets_overrides_and_skips_match_jax(arch, jax_side):
    """``arch_preset``, ``shape_rules_overrides``, ``applicable_shapes``
    and the skipped records (with their reasons) equal the JAX package's
    for every shape of the arch."""
    for name, shape in SHAPES.items():
        want = jax_side["cells"][f"{arch}/{name}"]
        got = json.loads(json.dumps(_port_cell(arch, name, shape)))
        assert got == want, f"{arch} x {name}"


def test_perf_cells_match_jax(jax_side):
    assert json.loads(json.dumps(perf.CELLS)) == jax_side["perf"]


def test_roofline_row_matches_jax_on_its_ceilings(jax_side, monkeypatch):
    """With the JAX package's v5e ceilings in ``DEVICE_PEAKS`` under a
    test name, a zero body (no scan correction) and XLA's fused "bytes
    accessed" as the port's fused count, each row equals the JAX
    package's key by key, and adds the unfused count."""
    v5e = {"hbm_bytes_per_s": 819e9, "link_bytes_per_s": 50e9,
           "flops_per_s": dict.fromkeys(("float32", "bfloat16", "float16"), 197e12)}
    monkeypatch.setitem(obs_roofline.DEVICE_PEAKS, "TPU v5e (test)", v5e)
    for i, (c, want) in enumerate(zip(ROOF_CELLS, jax_side["roofline"])):
        rec = _record(*c, i)
        rec = dict(rec, fused_bytes_accessed=rec["bytes_accessed"])
        got = roofline.roofline_cell(c[0], c[1], rec, device_name="TPU v5e (test)")
        assert list(got) == list(want) + ["unfused_bytes_per_chip"]
        assert got["unfused_bytes_per_chip"] == rec["bytes_accessed"]
        for k in want:
            assert got[k] == want[k], f"{c}: {k} {got[k]} != {want[k]}"


def test_roofline_uses_the_cards_ceilings():
    """By default a row divides by the H100's ceilings for the config's
    activation type: 989 TFLOP/s bf16, 3.35 TB/s, 900 GB/s.  The memory
    term is the fused count's, not the unfused upper bound's."""
    rec = _record("minicpm-2b", "train_4k", False, 1)
    row = roofline.roofline_cell("minicpm-2b", "train_4k", rec)
    assert get_config("minicpm-2b").dtype == "bfloat16"
    assert row["t_compute_s"] == rec["flops"] / 989e12
    assert row["t_memory_s"] == rec["fused_bytes_accessed"] / 3.35e12
    assert row["bytes_per_chip"] == rec["fused_bytes_accessed"]
    assert row["unfused_bytes_per_chip"] == rec["bytes_accessed"]
    assert row["t_collective_s"] == sum(rec["collective_bytes"].values()) / 900e9
    with pytest.raises(KeyError, match="no roofline ceilings"):
        roofline.roofline_cell("minicpm-2b", "train_4k", rec, device_name="TPU v5e")


# ------------------------------------------------------------ the copies
def _node(tree, name):
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and n.name == name:
            return n
        if isinstance(n, ast.Assign) and any(getattr(t, "id", None) == name
                                             for t in n.targets):
            return n
    raise KeyError(name)


def _source_tree(path):
    with open(path) as f:
        return ast.parse(f.read())


@pytest.mark.parametrize("module,name", [
    ("dryrun", "COLLECTIVES"), ("dryrun", "arch_preset"),
    ("dryrun", "shape_rules_overrides"), ("dryrun", "_skip_reason"), ("perf", "CELLS"),
])
def test_copy_is_the_jax_packages(module, name):
    mine = _source_tree(os.path.join(REPO, "src", "repro_torch", "launch", module + ".py"))
    ref = _source_tree(os.path.join(JAX_LAUNCH, module + ".py"))
    assert ast.dump(_node(mine, name)) == ast.dump(_node(ref, name))


# ------------------------------------------------- collective bytes vs XLA
_JAX_COLLECTIVES = """
import dataclasses, json, re
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.distributed.contract import sharded_contract
from repro.distributed.moe_a2a import moe_ffn_a2a
from repro.distributed.pipeline import pipeline_forward
from repro.launch.dryrun import collective_bytes

devs = np.array(jax.devices()[:8])
mesh = jax.sharding.Mesh(devs.reshape(2, 4), ("x", "y"))
A, B = jnp.ones((8, 12), jnp.float32), jnp.ones((12, 16), jnp.float32)
cases = {
    "psum": (lambda a, b: sharded_contract(
        "mk,kn->mn", a, b, mesh=mesh, in_specs=(P("x", "y"), P("y", None))), (A, B)),
    "reduce-scatter": (lambda a, b: sharded_contract(
        "mk,kn->mn", a, b, mesh=mesh, in_specs=(P("x", "y"), P("y", None)),
        out_spec=P("x", "y")), (A, B)),
    "all-gather": (lambda a, b: sharded_contract(
        "mk,kn->mn", a, b, mesh=mesh, in_specs=(P("x", None), P(None, "y")),
        out_spec=P(None, None)), (A, B)),
}
base = get_config("qwen2-moe-a2.7b", smoke=True)
cfg = base.with_(moe=dataclasses.replace(base.moe, n_experts=16, n_shared=0))
emesh = jax.sharding.Mesh(devs.reshape(2, 4), ("data", "model"))
p = {k: jnp.ones(s, jnp.float32) for k, s in %(moe_shapes)r.items()}
cases["moe_ffn_a2a"] = (lambda p, x: moe_ffn_a2a(cfg, p, x, emesh),
                        (p, jnp.ones(%(moe_x)r, jnp.float32)))
pmesh = jax.sharding.Mesh(devs.reshape(2, 4), ("pod", "x"))
cases["pipeline"] = (lambda sp, x: pipeline_forward(pmesh, lambda q, y, s: y @ q["w"], sp, x),
                     ({"w": jnp.ones(%(pipe_w)r, jnp.float32)}, jnp.ones(%(pipe_x)r, jnp.float32)))

_BYTES = {"f32": 4, "s32": 4, "bf16": 2, "s64": 8}
def tuple_bytes(hlo):
    # XLA on the CPU splits an all-to-all into a tuple of per-peer parts,
    # which collective_bytes reads as 0 bytes: sum the parts here
    total = 0
    for line in hlo.splitlines():
        if " all-to-all(" in line:
            lhs = line.split(" = ", 1)[1].split(" all-to-all(", 1)[0]
            for dt, dims in re.findall(r"(\\w+)\\[([\\d,]*)\\]", lhs):
                total += _BYTES[dt] * int(np.prod([int(d) for d in dims.split(",") if d]))
    return total

_DEF = re.compile(r"^\\s*(?:ROOT )?%%?([\\w.-]+) = \\w+\\[([\\d,]*)\\]")
def dot_flops(hlo):
    # 2 x the result's elements x the contracted extent, summed over the
    # module's dot instructions (a while body's once)
    dims = {}
    for line in hlo.splitlines():
        m = _DEF.match(line)
        if m:
            dims[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    assert " convolution(" not in hlo
    total = 0
    for line in hlo.splitlines():
        if " dot(" in line:
            m = _DEF.match(line)
            lhs = re.search(r" dot\\(%%?([\\w.-]+)", line).group(1)
            k = re.search(r"lhs_contracting_dims=\\{([\\d,]*)\\}", line).group(1)
            total += 2 * int(np.prod(dims[m.group(1)])) * int(
                np.prod([dims[lhs][int(i)] for i in k.split(",") if i]))
    return total

out = {}
for name, (fn, args) in cases.items():
    with emesh:
        compiled = jax.jit(fn).lower(*args).compile()
    hlo = compiled.as_text()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    coll = collective_bytes(hlo)
    out[name] = {"bytes": {k: v for k, v in coll.items() if k != "counts"},
                 "counts": coll["counts"], "a2a_tuple_bytes": tuple_bytes(hlo),
                 "flops": cost["flops"], "dot_flops": dot_flops(hlo)}
print(json.dumps(out))
"""

MOE_SHAPES = {"router": (64, 16), "wi": (16, 64, 32), "wg": (16, 64, 32), "wo": (16, 32, 64)}
MOE_X = (8, 8, 64)
#: the 2-stage pipeline's stage weights and microbatched input
PIPE_W, PIPE_X = (2, 16, 16), (4, 3, 16)


@pytest.fixture(scope="module")
def xla_collectives(jax_procs):
    return _result(jax_procs["collectives"])


def _port_case(name, mesh):
    from repro_torch.distributed.contract import sharded_contract
    from repro_torch.distributed.moe_a2a import moe_ffn_a2a
    from repro_torch.distributed.sharding import P

    A, B = torch.ones(8, 12), torch.ones(12, 16)
    if name == "psum":
        return lambda: sharded_contract("mk,kn->mn", A, B, mesh=mesh,
                                        in_specs=(P("x", "y"), P("y", None)))
    if name == "reduce-scatter":
        return lambda: sharded_contract("mk,kn->mn", A, B, mesh=mesh,
                                        in_specs=(P("x", "y"), P("y", None)),
                                        out_spec=P("x", "y"))
    if name == "all-gather":
        return lambda: sharded_contract("mk,kn->mn", A, B, mesh=mesh,
                                        in_specs=(P("x", None), P(None, "y")),
                                        out_spec=P(None, None))
    if name == "pipeline":
        from repro_torch.distributed.pipeline import pipeline_forward

        return lambda: pipeline_forward(mesh, lambda q, y, s: y @ q["w"],
                                        {"w": torch.ones(PIPE_W)}, torch.ones(PIPE_X))
    base = get_config("qwen2-moe-a2.7b", smoke=True)
    cfg = base.with_(moe=dataclasses.replace(base.moe, n_experts=16, n_shared=0))
    p = {k: torch.ones(s) for k, s in MOE_SHAPES.items()}
    return lambda: moe_ffn_a2a(cfg, p, torch.ones(MOE_X), mesh)


@pytest.mark.parametrize("name", ["psum", "reduce-scatter", "all-gather", "moe_ffn_a2a",
                                  "pipeline"])
def test_collective_bytes_match_xla(name, xla_collectives):
    """Per kind, the counter's collective bytes and counts on a fake world
    of 8 equal XLA's on 8 host devices, and its flops equal XLA's per
    device.  Where XLA's numbers differ, by design:

    * its cost analysis adds one flop per element of an all-reduce's
      result (the sum) and counts elementwise ops, where the counter counts
      products only: the counter's flops equal XLA's dot flops, and for the
      ``sharded_contract`` cases XLA's total is those plus the all-reduce's
      elements;
    * for the expert all-to-all XLA's result is a tuple of per-peer parts,
      which the JAX package's parser reads as 0 bytes: its all-to-all
      bytes are the parts' sum;
    * the pipeline's ticks are a ``fori_loop`` whose body XLA counts once
      (its ring shift, its product), where the port runs every tick: the
      port counts ``n_micro + n_stages - 1`` shifts, and one product per
      microbatch, since a stage with no microbatch at a tick passes its
      buffer on without computing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    want = xla_collectives[name]
    names = {"moe_ffn_a2a": ("data", "model"), "pipeline": ("pod", "x")}.get(name, ("x", "y"))
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=names)
        with FakeTensorMode(), CostCounter() as cc:
            _port_case(name, mesh)()
    got = cc.costs()
    flops, counts, nbytes = want["dot_flops"], want["counts"], want["bytes"]
    if name in ("psum", "reduce-scatter", "all-gather"):
        assert want["flops"] == flops + nbytes["all-reduce"] // 4  # float32 elements
    if name == "moe_ffn_a2a":
        assert nbytes["all-to-all"] == 0 < want["a2a_tuple_bytes"]
        nbytes["all-to-all"] = want["a2a_tuple_bytes"]
    if name == "pipeline":
        n_micro, n_ticks = PIPE_X[0], PIPE_X[0] + PIPE_W[0] - 1
        assert counts["collective-permute"] == 1
        counts["collective-permute"] *= n_ticks
        nbytes["collective-permute"] *= n_ticks
        flops *= n_micro
    assert got["collective_counts"] == counts
    assert got["collective_bytes"] == nbytes
    assert got["flops"] == flops > 0


# --------------------------------------------------------- the counter
def test_dtensor_product_counts_local_flops():
    """A ``Shard(0)`` x ``Replicate()`` product (1024, 4096) @ (4096, 4096)
    on a fake world of 4 counts its local block once: 2·256·4096·4096."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (4,))
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(256, 4096), mesh, [Shard(0)], run_check=False)
            b = DTensor.from_local(torch.empty(4096, 4096), mesh, [Replicate()],
                                   run_check=False)
            for _ in range(2):  # the second call hits DTensor's cached shape
                with CostCounter() as cc:
                    a @ b
                assert cc.flops == 8_589_934_592
                assert not any(cc.costs()["collective_counts"].values())


def test_counter_bytes_and_peak_on_real_tensors():
    """Bytes count each non-view op's inputs and outputs; a view moves
    nothing; the peak is the arguments plus what is live at once, and
    ``peak_live`` names what was live there."""
    x, y = torch.ones(1000), torch.ones(1000)
    with CostCounter() as cc:
        assert cc.hold((x, y)) == 8000
        z = x + y              # reads 8000, writes 4000
        w = z.view(10, 100)    # a view: nothing
        del z, w
        u = x * 2              # reads 4000 (the scalar is no tensor), writes 4000
        del u
    c = cc.costs()
    assert c["bytes"] == 12000 + 8000
    assert c["argument_bytes"] == 8000 and c["peak_bytes"] == 12000
    assert c["temp_bytes"] == 4000 and cc.live_bytes == 8000
    assert c["flops"] == 0
    assert c["peak_live"] == [
        {"op": "argument", "shape": [1000], "dtype": "float32", "count": 2, "bytes": 8000},
        {"op": "aten.add.Tensor", "shape": [1000], "dtype": "float32", "count": 1,
         "bytes": 4000}]


def test_fused_bytes_count_each_storage_once():
    """The fused count takes each storage that the step holds, returns or
    a product reads or writes once; other ops are taken as fused into the
    products; a storage freed and made again counts again."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)   # 512 and 256 bytes
    with CostCounter() as cc:
        cc.hold((a, b))
        c = a @ b                 # writes c (128); reads a and b, counted
        d = torch.relu(c)         # no product: fused
        e = d @ b.t()             # reads d (128) and a view of b; writes e (512)
        assert cc.output((e, e.view(-1))) == 512
        for _ in range(3):        # three storages one after another, 128 each
            del c
            c = a @ b
    assert cc.fused_bytes == 768 + 128 + 128 + 512 + 3 * 128
    assert cc.output_bytes == 512
    assert cc.flops == 5 * (2 * 8 * 16 * 4)
    assert cc.bytes > cc.fused_bytes


def test_propagation_on_another_thread_mutes_only_that_thread(monkeypatch):
    """DTensor's shape propagation mutes the counter on its own thread
    only: a product on the counter's thread, while another thread is
    inside a propagation, is counted."""
    import threading

    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    inside, release = threading.Event(), threading.Event()

    def slow_propagation(prop, op_schema):
        inside.set()
        release.wait(30)

    monkeypatch.setattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                        slow_propagation)
    with CostCounter() as cc:
        other = threading.Thread(
            target=lambda: ShardingPropagator._propagate_tensor_meta_non_cached(None, None))
        other.start()
        assert inside.wait(30)
        torch.ones(2, 3) @ torch.ones(3, 4)
        release.set()
        other.join()
    assert cc.flops == 2 * 2 * 3 * 4
    assert ShardingPropagator._propagate_tensor_meta_non_cached is slow_propagation


def test_counter_refuses_a_torch_without_the_propagation_hook(monkeypatch):
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    monkeypatch.delattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta_non_cached"):
        with CostCounter():
            pass


def test_counter_maps_every_collective_kind():
    from repro_torch.utils import COLLECTIVE_KINDS, collective_kind

    assert set(COLLECTIVE_KINDS) == set(dryrun.COLLECTIVES)
    import torch.distributed._functional_collectives  # noqa: F401  registers the ops

    ops = torch.ops._c10d_functional
    assert collective_kind(ops.all_reduce.default) == "all-reduce"
    assert collective_kind(ops.all_gather_into_tensor.default) == "all-gather"
    assert collective_kind(ops.reduce_scatter_tensor.default) == "reduce-scatter"
    assert collective_kind(ops.all_to_all_single.default) == "all-to-all"
    assert collective_kind(ops.wait_tensor.default) is None
    # a ring shift counts once, on its receiving side
    assert collective_kind(torch.ops.c10d.recv_.default) == "collective-permute"
    assert collective_kind(torch.ops.c10d.send.default) is None
    assert collective_kind(torch.ops.aten.mm.default) is None


# ------------------------------------------------------------ the cells
def test_dryrun_smoke_cell_compiles_on_512_devices(smoke):
    """A reduced config through the real dry-run path on the 16x16 mesh
    and the 2x16x16 one (the JAX package's test, red there on jax 0.9)."""
    rec = dryrun.dryrun_cell("minicpm-2b", "train_4k", verbose=False, device="cpu")
    assert rec["status"] == "ok", rec
    rec2 = dryrun.dryrun_cell("minicpm-2b", "train_4k", multi_pod=True, verbose=False,
                              device="cpu")
    assert rec2["status"] == "ok", rec2
    assert rec2["mesh"] == "2x16x16"
    for r in (rec, rec2):
        assert r["flops"] > 0 and r["peak_bytes_per_device"] > r["argument_bytes"] > 0
        assert 0 < sum(g["bytes"] for g in r["peak_live"]) <= r["peak_bytes_per_device"]
        # the data axis sums the gradients
        assert r["collective_bytes"]["all-reduce"] + r["collective_bytes"]["reduce-scatter"] > 0
    assert not dist.is_initialized()


def test_skip_cells_report_reasons():
    rec = dryrun.dryrun_cell("hubert-xlarge", "decode_32k")
    assert rec["status"] == "skipped" and "encoder-only" in rec["reason"], rec
    rec = dryrun.dryrun_cell("gemma2-27b", "long_500k")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"], rec


@pytest.mark.parametrize("arch,shape", [("minicpm-2b", "train_4k"),
                                        ("internlm2-20b", "decode_32k")])
def test_period_difference_equals_body_costs(arch, shape, smoke):
    """The record holds every period (no scan correction): the smoke
    cell's costs grow from two periods to three by ``body_costs``, the
    growth from one to two, which is above zero and below the whole
    cell's."""
    recs = {n: dryrun.dryrun_cell(arch, shape, verbose=False, device="cpu",
                                  cfg_overrides={"n_periods": n}) for n in (2, 3)}
    terms = {"flops": lambda r: r["flops"], "bytes": lambda r: r["fused_bytes_accessed"],
             "collective": lambda r: sum(r["collective_bytes"].values())}
    body = roofline.body_costs(arch, shape, device="cpu")
    for k, of in terms.items():
        assert of(recs[3]) - of(recs[2]) == body[k], k
    assert 0 < body["flops"] < recs[2]["flops"]
    assert 0 < body["bytes"] < recs[2]["fused_bytes_accessed"]


def _shard_bytes(leaf, sharding) -> int:
    n = leaf.numel() * leaf.element_size()
    sizes = dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.shape))
    for entry in sharding.spec:
        for ax in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n //= sizes[ax]
    return n


def test_argument_bytes_are_the_shards(smoke):
    """On a 2x4 mesh of a fake world of 8, the traced train step's
    argument bytes are the sum of every parameter, moment and batch
    shard's bytes, each from its ``NamedSharding``."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg, opt_cfg = dryrun.arch_preset(smoke_config("minicpm-2b"))
    shape = SHAPES["train_4k"]
    params = init_params(None, cfg, device="meta")
    opt = adamw_init(params)
    batch = make_batch_specs(cfg, shape)
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh)
        want = 0
        for tree, axes in ((params, sh.param_logical_axes(params)),
                           (opt, sh.opt_state_logical_axes(params)),
                           (batch, sh.batch_logical_axes(batch))):
            shardings = sh.tree_shardings(rules, axes, tree)
            want += sum(map(_shard_bytes, tree_leaves(tree), tree_leaves(shardings)))
        costs = dryrun.trace_step(cfg, opt_cfg, shape, rules, "cpu")
    assert costs["argument_bytes"] == want
    assert costs["flops"] > 0 and costs["peak_bytes"] > want


#: the kernel backend as a training config takes it: the role-based core is
#: forward only, so a step differentiates through ``strategy="native"``
KERNEL = {"contract_backend": "kernel", "contract_strategy": "native"}


def test_kernel_backend_cell_traces(smoke):
    """The smoke minicpm-2b ``train_4k`` cell on 16x16 on the kernel
    backend: ``ok``, one ``repro_torch.native_gemm`` op per block product.
    Its flops are the torch backend's plus one product a layer: remat's
    recompute (``torch.utils.checkpoint``, non-reentrant) stops once it has
    every tensor the backward saved, which an ``aten.mm`` saves before it
    runs and an ``autograd.Function`` after, so the recompute runs each
    layer's last product, the MLP's down projection, on the kernel backend
    alone.  No world is left behind."""
    torch_rec = dryrun.dryrun_cell("minicpm-2b", "train_4k", verbose=False, device="cpu")
    rec = dryrun.dryrun_cell("minicpm-2b", "train_4k", verbose=False, device="cpu",
                             cfg_overrides=KERNEL)
    assert not dist.is_initialized()
    assert rec["status"] == torch_rec["status"] == "ok", rec
    cfg, shape = smoke_config("minicpm-2b"), SHAPES["train_4k"]
    # the down projection's local product: tokens over data, d_ff over model
    down = 2 * shape.global_batch * shape.seq_len * cfg.d_ff * cfg.d_model // 256
    assert rec["flops"] == torch_rec["flops"] + cfg.n_periods * down
    n = 36 * cfg.n_periods + 3   # 9 a layer and the head, remat, 2 a product's backward
    assert rec["ops"] == {"repro_torch.native_gemm": n}
    assert sum(rec["routes"]["repro_torch.native_gemm"].values()) == n
    assert sum(torch_rec["ops"].values()) == n - cfg.n_periods
    assert set(torch_rec["ops"]) == {"aten.mm", "aten.bmm"} and torch_rec["routes"] == {}
    assert rec["collective_bytes"]["all-reduce"] + rec["collective_bytes"]["reduce-scatter"] > 0


def test_kimi_a2a_smoke_variant_traces_on_16x16(smoke):
    """``perf.CELLS``' kimi a2a_moe variant (smoke widths) traces on 16x16:
    the expert stack's exchange runs on fake tensors."""
    (over,) = [o for v, o, _ in perf.CELLS["kimi_train"]["variants"] if v == "a2a_moe"]
    rec = dryrun.dryrun_cell("kimi-k2-1t-a32b", "train_4k", cfg_overrides=over,
                             verbose=False, device="cpu")
    assert rec["status"] == "ok" and rec["collective_counts"]["all-to-all"] > 0, rec


# ------------------------------------------------------------ the world
def test_import_leaves_the_environment_unchanged():
    code = """
    import json, os
    before = dict(os.environ)
    import repro_torch.launch.dryrun, repro_torch.launch.roofline
    import repro_torch.launch.perf, repro_torch.launch.report, repro_torch.utils
    import torch.distributed as dist
    print(json.dumps([dict(os.environ) == before, dist.is_initialized()]))
    """
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], text=True,
                          capture_output=True, stdin=subprocess.DEVNULL, timeout=120,
                          env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True, False]


def test_world_is_torn_down_on_success_and_error(smoke, monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh

    dryrun.dryrun_cell("minicpm-2b", "train_4k", verbose=False, device="cpu")
    assert not dist.is_initialized()

    def boom(*a, **kw):
        assert dist.get_world_size() == 256
        raise RuntimeError("traced step failed")

    monkeypatch.setattr(dryrun, "trace_step", boom)
    with pytest.raises(RuntimeError, match="traced step failed"):
        dryrun.dryrun_cell("minicpm-2b", "train_4k", verbose=False, device="cpu")
    assert not dist.is_initialized()
    make_host_mesh(1, 1, device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_dryrun_never_joins_a_started_world(smoke):
    from repro_torch.launch.mesh import make_host_mesh

    make_host_mesh(1, 1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.dryrun_cell("minicpm-2b", "train_4k", verbose=False, device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- moe_a2a
@pytest.mark.parametrize("sizes,n_experts", [((2, 4), 16), ((2, 4), 4), ((2, 4), 60),
                                             ((16, 16), 384), ((16, 16), 60)])
def test_owned_counts_equal_bincount(sizes, n_experts):
    """The a2a's per-rank expert counts of each flat block, from integers,
    equal the ``bincount`` of the block's owners they replace."""
    D = sizes[0] * sizes[1]
    for lo, hi in _flat_blocks(n_experts, sizes):
        want = torch.bincount(torch.arange(lo, hi) % D, minlength=D).tolist()
        assert owned_counts(lo, hi, D) == want, (lo, hi)
    idx = torch.randint(0, D, (500,), generator=torch.Generator().manual_seed(0))
    assert torch.equal(_bincount(idx, D), torch.bincount(idx, minlength=D))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_traced_step_counts_what_the_real_step_does(backend):
    """Phase 13's step at smoke widths on the CPU: traced on fake tensors,
    it counts the flops, bytes (unfused and fused), peak, products by op
    and ``native_gemm``'s routes that the same step counts run on real
    tensors (a fake tensor's metadata queries move nothing), on both
    backends; on the kernel backend every product is one
    ``repro_torch.native_gemm`` op, 147 a step at 4 layers as on the card
    (75 at these 2)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, make_train_step

    cfg = smoke_config("minicpm-2b").with_(n_periods=2, **(KERNEL if backend == "kernel"
                                                          else {}))
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig()))

    def run(params):
        batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32)}
        state = adamw_init(params)
        with CostCounter() as cc:
            cc.hold((params, state, batch))
            cc.output(step(params, state, batch, None))
        return cc.costs()

    with FakeTensorMode():
        traced = run(init_params(None, cfg, device="cpu"))
    real = run(init_params(torch.Generator().manual_seed(0), cfg))
    assert traced == real
    assert real["flops"] > 0 and real["peak_bytes"] > real["argument_bytes"] > 0
    if backend == "kernel":
        assert real["ops"] == {"repro_torch.native_gemm": 36 * 2 + 3}
        assert sum(real["routes"]["repro_torch.native_gemm"].values()) == 36 * 2 + 3
    else:
        assert real["routes"] == {} and real["ops"].keys() <= {"aten.mm", "aten.bmm"}
    assert real["bytes"] > real["fused_bytes"] > real["argument_bytes"] + real["output_bytes"]
