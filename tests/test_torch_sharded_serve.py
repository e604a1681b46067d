"""The port of ``test_serve_engine_sharded_matches_single_device``
(``tests/test_sharded_contract.py``), on a 2x4 gloo world of CPU ranks.

minicpm-2b smoke, the JAX package's weights as numpy, 2 slots,
``max_len`` 64, two 6-token prompts x 4 greedy tokens: ``ServeEngine(mesh=)``
on every rank gives the port's single-process tokens and the JAX
``ServeEngine``'s, on both backends (``torch``, and ``kernel`` with
``strategy="native"``); so does the continuous-batching runtime with
chunked prefill and bucketed decode on ragged prompts, and a
qwen2-moe-a2.7b runtime whose MoE layers take the expert all-to-all
(``moe_impl="a2a"``, no token dropped) gives the single-process tokens.
``paged=True`` with a mesh raises, as in the JAX package.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_world
from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)

ARCH = "minicpm-2b"
BACKENDS = {"torch": {}, "kernel": {"contract_backend": "kernel",
                                    "contract_strategy": "native"}}


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 4), ("data", "model"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config(ARCH, smoke=True)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=6).astype(np.int32) for _ in range(2)]
    reqs = [JRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    JServeEngine(jcfg, jp, slots=2, max_len=64).serve(reqs)
    return jax.tree.map(np.asarray, jp), prompts, [list(r.output) for r in reqs]


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_serve_engine_sharded_matches_single_device(world, served, backend):
    np_params, prompts, jax_tokens = served
    cfg = get_config(ARCH, smoke=True).with_(**BACKENDS[backend])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ServeEngine(cfg, params_from_numpy(cfg, np_params, "cpu"), slots=2, max_len=64).serve(reqs)
    single = [list(r.output) for r in reqs]
    assert single == jax_tokens
    sharded = world.run(torch_world.sharded_serve, ARCH, BACKENDS[backend], np_params,
                        prompts, 4, dict(slots=2, max_len=64))
    assert all(s == single for s in sharded), (sharded, single)


def test_runtime_sharded_chunked_and_bucketed(world, served):
    np_params, _, _ = served
    cfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 3, 6)]
    kw = dict(slots=2, max_len=64, prefill_chunk=4)
    from repro_torch.runtime.engine import ServingRuntime

    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ServingRuntime(cfg, params_from_numpy(cfg, np_params, "cpu"), **kw).serve(reqs)
    sharded = world.run(torch_world.sharded_serve, ARCH, {}, np_params, prompts, 4, kw, False)
    assert all(s == [list(r.output) for r in reqs] for s in sharded)


def test_runtime_sharded_a2a_matches_single_process(world):
    """qwen2-moe-a2.7b smoke with ``moe_impl="a2a"`` at a capacity factor
    where no token drops: 8-token prefill chunks run the expert
    all-to-all over the 8 ranks, the 1-token chunk and the decode rows
    (each row a request of its own) the GShard path, and the tokens are
    the single-process runtime's."""
    from repro_torch.models.transformer import init_params
    from repro_torch.models.tree import tree_map
    from repro_torch.runtime.engine import ServingRuntime

    arch = "qwen2-moe-a2.7b"
    m = get_config(arch, smoke=True).moe
    over = dict(moe_impl="a2a", moe=dataclasses.replace(m, capacity_factor=64.0))
    cfg = get_config(arch, smoke=True).with_(**over)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (16, 9, 8)]
    kw = dict(slots=2, max_len=64, prefill_chunk=8)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ServingRuntime(cfg, params, **kw).serve(reqs)
    sharded = world.run(torch_world.sharded_serve, arch, over,
                        tree_map(lambda t: t.numpy(), params), prompts, 4, kw, False)
    assert all(s == [list(r.output) for r in reqs] for s in sharded), sharded


def test_paged_runtime_refuses_a_mesh(world, served):
    np_params, prompts, _ = served
    with pytest.raises(torch_world.RankError, match="paged"):
        world.run(torch_world.sharded_serve, ARCH, {}, np_params, prompts, 4,
                  dict(slots=2, max_len=64, paged=True), False)
