"""The port's ``contract`` against the JAX package's, strategy by strategy.

The same numpy inputs go through both packages.  JAX runs on the CPU, its
kernel backend in interpret mode as its own tests run it; the port's
``"kernel"`` backend runs the kernel's plain version on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutfuzz import gen_layout_case
from repro.core.contract import contract as jcontract
from repro.core.table2 import CASES
from repro_torch.core.contract import (
    conventional_transpose_count,
    contract,
    count_copy_ops,
    record_contractions,
)
from repro_torch.distributed.sharding import P
from repro_torch.interop import from_numpy
from repro_torch.kernels.ext_gemm import ext_gemm

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()

#: (strategy, port backend); strategies that ignore the backend run once
COMBOS = [("auto", "torch"), ("auto", "kernel"), ("flatten", "torch"),
          ("flatten", "kernel"), ("batched", "torch"), ("batched", "kernel"),
          ("direct", "torch"), ("conventional", "torch"), ("native", "kernel")]

# the SHAPE_SWEEP of tests/test_kernels.py
SHAPE_SWEEP = [
    {"m": 1, "n": 1, "p": 1, "k": 1},
    {"m": 5, "n": 7, "p": 3, "k": 4},
    {"m": 16, "n": 8, "p": 2, "k": 32},
    {"m": 130, "n": 65, "p": 9, "k": 200},
    {"m": 256, "n": 128, "p": 4, "k": 128},
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # the tolerances of tests/test_kernels.py: bf16 keeps ~3 digits
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=2e-5, atol=2e-5)


def _operands(rng, spec, dims):
    a, rest = spec.split(",")
    b, _ = rest.split("->")
    return (rng.standard_normal([dims[m] for m in a]).astype(np.float32),
            rng.standard_normal([dims[m] for m in b]).astype(np.float32))


def _flattenable(spec, dims):
    from repro_torch.core.notation import CaseKind, parse_spec
    from repro_torch.core.planner import make_plan

    return make_plan(parse_spec(spec), dims).kind == CaseKind.FLAT_GEMM


@pytest.mark.parametrize("dims", SHAPE_SWEEP, ids=lambda d: "x".join(map(str, d.values())))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("label", ["1.1", "1.3", "2.4", "4.1", "5.3"])
def test_shape_sweep_matches_jax(dims, dtype, label):
    rng = np.random.default_rng(0)
    rm = CASES[label].row_major()
    An, Bn = _operands(rng, rm, dims)
    _, jdt, tdt = DTYPES[dtype]
    Aj, Bj = jnp.asarray(An, jdt), jnp.asarray(Bn, jdt)
    At, Bt = torch.from_numpy(An).to(tdt), torch.from_numpy(Bn).to(tdt)
    # the JAX package's kernel path, as tests/test_kernels.py runs it
    want = np.asarray(jcontract(rm, Aj, Bj, strategy="batched", backend="pallas",
                                out_dtype=jnp.float32))
    for strategy, backend in COMBOS:
        if strategy == "flatten" and not _flattenable(rm, dims):
            continue
        got = contract(rm, At, Bt, strategy=strategy, backend=backend,
                       out_dtype=torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **_tol(dtype),
                                   err_msg=f"{rm} {strategy}/{backend}")


@pytest.mark.parametrize("block", range(4))
def test_layoutfuzz_bit_identical_to_jax(block):
    """Integer-valued operands through every layout treatment: each sum is
    exact, so port and JAX must agree bit for bit."""
    for i in range(block * 6, (block + 1) * 6):
        cs, dims, An, Bn, tr = gen_layout_case(i)
        spec = cs.spec_str()
        At, Bt = from_numpy((An, Bn), device="cpu")
        # the JAX package's native kernel, the one the port's kernel replaces
        want = np.asarray(jcontract(spec, jnp.asarray(An), jnp.asarray(Bn),
                                    strategy="native"))
        for strategy, backend in COMBOS:
            if strategy == "flatten" and not _flattenable(spec, dims):
                continue
            got = contract(spec, At, Bt, strategy=strategy, backend=backend)
            assert np.array_equal(got.numpy(), want), (i, spec, tr, strategy, backend)


def test_ext_gemm_rejects_regular_cases():
    rm = CASES["1.1"].row_major()
    with pytest.raises(ValueError, match="not exceptional"):
        ext_gemm(rm, torch.zeros(4, 6), torch.zeros(3, 10, 4))


def test_unknown_strategy_and_backend_rejected():
    A = torch.ones(2, 2)
    with pytest.raises(ValueError, match="unknown strategy"):
        contract("mk,kn->mn", A, A, strategy="nativ")
    with pytest.raises(ValueError, match="unknown backend"):
        contract("mk,kn->mn", A, A, backend="xla")
    with pytest.raises(ValueError, match="admits no flattened"):
        contract("km,pkn->pnm", A, torch.ones(3, 2, 4), strategy="flatten")


@pytest.mark.parametrize("kwargs, error, match", [
    ({"mesh": object()}, TypeError, "DeviceMesh"),
    ({"in_specs": (None, None)}, ValueError, "require mesh"),
    ({"out_spec": P()}, ValueError, "require mesh"),
])
def test_unported_options_raise_naming_the_roadmap(kwargs, error, match):
    """The sharding options are checked as the JAX package checks them:
    ``in_specs``/``out_spec`` need ``mesh=``, and a mesh must be a
    ``DeviceMesh``."""
    A = torch.ones(2, 2)
    with pytest.raises(error, match=match):
        contract("mk,kn->mn", A, A, **kwargs)


def test_operands_on_different_devices_raise():
    with pytest.raises(ValueError, match="different devices"):
        contract("mk,kn->mn", torch.ones(2, 2), torch.ones(2, 2, device="meta"))


def test_record_contractions_and_transpose_counts_match_jax():
    from repro.core.contract import conventional_transpose_count as jcount
    from repro.core.contract import record_contractions as jrecord

    A, B = np.ones((4, 6), np.float32), np.ones((3, 4, 5), np.float32)
    with record_contractions() as rec:
        contract("km,pkn->pnm", torch.from_numpy(A), torch.from_numpy(B))
    with jrecord() as jrec:
        jcontract("km,pkn->pnm", jnp.asarray(A), jnp.asarray(B))
    assert rec == [(s, {m: int(d) for m, d in dims.items()}, dt) for s, dims, dt in jrec]
    for label, c in CASES.items():
        assert conventional_transpose_count(c.row_major()) == jcount(c.row_major())


def test_conventional_copies_counted_by_the_profiler():
    """The conventional baseline materialises at least one copy per
    transpose it counts; the torch backend's planned path makes none."""
    T, W = torch.randn(6, 5, 4), torch.randn(5, 3)
    spec = "mnk,nj->mjk"
    conv = count_copy_ops(lambda: contract(spec, T, W, strategy="conventional"))
    assert sum(conv.values()) >= conventional_transpose_count(spec) >= 1
    auto = count_copy_ops(lambda: contract(spec, T, W, strategy="auto"))
    assert sum(auto.values()) == 0
