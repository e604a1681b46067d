"""The port's ``launch/shardings`` against the JAX package's.

For every architecture's full config, the resolved ``PartitionSpec`` of
every parameter leaf and of every ZeRO-1 optimizer-state leaf
(``tree_shardings`` over ``param_logical_axes`` / ``opt_state_logical_axes``,
size-aware) equal the JAX package's, on a 2x4 and a 16x16
``("data", "model")`` mesh.  Shapes only: the port's from the meta device
on a ``DeviceMesh`` of torch's fake process group, the JAX package's from
``jax.eval_shape`` in a subprocess with simulated host devices (as
``tests/test_distributed.py`` runs its meshes).  Nothing is allocated.
The rule table is a copy, pinned by syntax tree; the port's cache rules
are its own (its cache tree differs) and are held to what they shard.
"""

import ast
import contextlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro.launch import shardings as jshardings
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import P, ShardingRules, specs_equal
from repro_torch.launch import shardings
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.models.tree import tree_leaves_with_path
from repro_torch.training.optimizer import adamw_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 4), (16, 16))

_JAX_SPECS = """
import json, jax, jax.numpy as jnp
from repro.configs import get_config, list_archs
from repro.distributed.sharding import ShardingRules
from repro.launch.shardings import (opt_state_logical_axes, param_logical_axes,
                                    tree_shardings)
from repro.models.transformer import init_params

def path(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)

def specs(tree):
    return {path(p): [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for p, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))}

out = {}
for shape in %(meshes)r:
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n])
    rules = ShardingRules(mesh)
    for arch in list_archs():
        cfg = get_config(arch)
        p = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
        o = {"mu": p, "nu": p, "step": jax.ShapeDtypeStruct((), jnp.int32)}
        out["%%s/%%dx%%d" %% (arch, *shape)] = {
            "params": specs(tree_shardings(rules, param_logical_axes(p), p)),
            "opt": specs(tree_shardings(rules, opt_state_logical_axes(p), o)),
        }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=256", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SPECS % {
        "meshes": MESHES})], capture_output=True, text=True, env=env, timeout=300,
        stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def fake_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _specs(tree) -> dict:
    return {"/".join(map(str, path)): s.spec for path, s in tree_leaves_with_path(tree)}


def _same(mine: dict, ref: dict, what: str):
    assert sorted(mine) == sorted(ref), what
    for k, spec in mine.items():
        want = P(*[tuple(e) if isinstance(e, list) else e for e in ref[k]])
        assert specs_equal(spec, want), f"{what} {k}: {spec} != {want}"


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_zero1_specs_match_jax(arch, shape, jax_specs):
    ref = jax_specs["%s/%dx%d" % (arch, *shape)]
    params = init_params(None, get_config(arch), device="meta")
    opt = adamw_init(params)
    with fake_mesh(shape) as mesh:
        rules = ShardingRules(mesh)
        p_sh = shardings.tree_shardings(rules, shardings.param_logical_axes(params), params)
        o_sh = shardings.tree_shardings(rules, shardings.opt_state_logical_axes(params), opt)
    _same(_specs(p_sh), ref["params"], f"{arch} params")
    _same(_specs(o_sh), ref["opt"], f"{arch} opt state")


def test_expert_stack_that_does_not_divide_is_replicated():
    """qwen2's 60 experts over a 16-way axis: the size-aware drop leaves
    the expert dim unsharded, as the JAX package's docstring says."""
    params = init_params(None, get_config("qwen2-moe-a2.7b"), device="meta")
    with fake_mesh((16, 16)) as mesh:
        sh = shardings.tree_shardings(ShardingRules(mesh),
                                      shardings.param_logical_axes(params), params)
    wi = sh["pattern"][0]["moe"]["wi"]
    assert params["pattern"][0]["moe"]["wi"].shape[1] == 60
    assert wi.spec[1] is None


def _module_ast(mod, name: str) -> str:
    tree = ast.parse(inspect.getsource(mod))
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", None) == name)
    return ast.dump(node)


def test_rule_table_is_the_jax_packages():
    assert _module_ast(shardings, "_RULES") == _module_ast(jshardings, "_RULES")


def test_cache_rules_shard_what_the_jax_package_shards():
    """The port's caches keep the row (request) axis unsharded, as the
    JAX runtime never shards its slot axis nor the batch-1 dim inside a
    slot; the KV rows go over ``kv_seq`` (model), SSM channels over
    ``ff`` and SSM heads over ``heads``; lengths are replicated."""
    for arch, want in (("minicpm-2b", {"k": P(None, None, "model"),
                                       "v": P(None, None, "model")}),
                       ("mamba2-1.3b", {"conv": P(None, None, None, "model"),
                                        "state": P(None, None, "model")})):
        cfg = get_config(arch, smoke=True)
        cache = init_cache(cfg, 2, 16, device="meta")
        with fake_mesh((2, 4)) as mesh:
            sh = shardings.tree_shardings(ShardingRules(mesh),
                                          shardings.cache_logical_axes(cache), cache)
        for path, s in tree_leaves_with_path(sh):
            name = path[-1]
            if name == "length":
                assert specs_equal(s.spec, P())
            else:
                assert specs_equal(s.spec, want[name]), (arch, path, s.spec)


def test_batch_axes_and_opt_state_structure():
    batch = {"tokens": torch.zeros(8, 4), "features": torch.zeros(8, 4, 3)}
    assert shardings.batch_logical_axes(batch) == {
        "tokens": ("batch", None), "features": ("batch", None, None)}
    params = {"embed": torch.zeros(4, 2), "pattern": [{"attn": {"wq": torch.zeros(2, 3, 4)}}]}
    axes = shardings.opt_state_logical_axes(params)
    assert axes["step"] == ()
    assert axes["mu"]["embed"] == ("vocab", "d_model")           # nothing unsharded
    assert axes["mu"]["pattern"][0]["attn"]["wq"] == (None, "zero1", "heads")
    assert shardings.opt_state_logical_axes(params, zero1=False)["nu"] == \
        shardings.param_logical_axes(params)
