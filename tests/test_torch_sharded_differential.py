"""The sharded half of the differential fuzzer, for the port: seeded random
specs through ``xeinsum(..., mesh=...)`` on a 2x2 gloo world of CPU ranks
must match the JAX package's single-device ``xeinsum`` on the same numpy
operands (atol and rtol 1e-4, as in ``tests/test_differential.py``).

The generators are copies of the reference's (same ``SEED``, the same
``default_rng([SEED, i])`` streams, the same ``_seeded_shardings``), so
chunk ``c`` here draws exactly the specs, dims, operands and shardings of
the reference's chunk ``c``: 60 pairwise specs in 6 chunks and 40 n-ary
specs in 4.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from repro.core.einsum import parse_nary
from repro.core.einsum import xeinsum as jxeinsum
from repro_torch.core.notation import ContractionSpec
from repro_torch.distributed.sharding import P

torch.set_num_threads(1)

SEED = 20260801
N_PAIRWISE = 120
N_NARY = 80
CHUNK = 10  # specs per pytest case: granular repro without 200 items


@pytest.fixture(scope="module")
def world():
    w = torch_world.World((2, 2), ("x", "y"))
    yield w
    w.close()


# ------------------------------------------------------------ generators
def gen_pairwise(rng) -> tuple[ContractionSpec, dict]:
    """One random valid pairwise spec with operand/output orders 2–5."""
    letters = "abcdefghij"
    while True:
        n_k = int(rng.integers(1, 3))    # contracted modes
        n_b = int(rng.integers(0, 3))    # shared batch modes
        n_af = int(rng.integers(1, 3))   # A's free modes
        n_bf = int(rng.integers(1, 3))   # B's free modes
        ra, rb = n_af + n_k + n_b, n_bf + n_k + n_b
        rc = n_af + n_bf + n_b
        if not (2 <= ra <= 5 and 2 <= rb <= 5 and 2 <= rc <= 5):
            continue
        ms = list(letters[: n_k + n_b + n_af + n_bf])
        k = ms[:n_k]
        b = ms[n_k:n_k + n_b]
        af = ms[n_k + n_b:n_k + n_b + n_af]
        bf = ms[n_k + n_b + n_af:]
        a_modes = "".join(rng.permutation(af + k + b))
        b_modes = "".join(rng.permutation(bf + k + b))
        c_modes = "".join(rng.permutation(af + bf + b))
        cs = ContractionSpec(a_modes, b_modes, c_modes)
        try:
            cs.validate()
        except ValueError:
            continue
        dims = {m: int(rng.integers(2, 6)) for m in ms}
        return cs, dims


def gen_nary(rng) -> tuple[str, dict]:
    """One random n-ary spec (3–4 operands, orders 1–4, dims 2–4).

    May include sum-only modes, outer products, contracted batch modes,
    and (one in five) an implicit output.
    """
    pool = "abcdefg"[: int(rng.integers(4, 8))]
    dims = {m: int(rng.integers(2, 5)) for m in pool}
    n_ops = int(rng.integers(3, 5))
    inputs = []
    for _ in range(n_ops):
        rank = int(rng.integers(1, 5))
        modes = rng.choice(list(pool), size=min(rank, len(pool)), replace=False)
        inputs.append("".join(modes))
    counts = collections.Counter(m for t in inputs for m in t)
    used = [m for m in pool if counts[m]]
    if rng.integers(0, 5) == 0:
        spec = ",".join(inputs)  # implicit output
    else:
        n_out = int(rng.integers(0, min(4, len(used)) + 1))
        out = "".join(rng.choice(used, size=n_out, replace=False))
        spec = ",".join(inputs) + "->" + out
    return spec, dims


def operands_for(mode_strings, dims, rng):
    return [
        rng.standard_normal([dims[m] for m in modes]).astype(np.float32)
        for modes in mode_strings
    ]


def _chunks(n):
    return [
        pytest.param(c, id=f"specs{c * CHUNK}-{min((c + 1) * CHUNK, n) - 1}")
        for c in range((n + CHUNK - 1) // CHUNK)
    ]


def _seeded_shardings(mode_strings, output, dims, axis_sizes):
    """Shard up to one even-dim surviving mode per mesh axis (seeded by
    the spec itself, so the coverage is deterministic)."""
    counts = collections.Counter(m for t in mode_strings for m in t)
    surviving = [
        m for m in dict.fromkeys("".join(mode_strings))
        if (counts[m] > 1 or m in output)
    ]
    shard = {}
    for ax, size in axis_sizes.items():
        for m in surviving:
            if m not in shard and dims[m] % size == 0:
                shard[m] = ax
                break
    return shard, tuple(P(*[shard.get(m) for m in t]) for t in mode_strings)


AXES = {"x": 2, "y": 2}


def _check(world, spec, ops, in_specs, msg):
    single = np.asarray(jxeinsum(spec, *map(jnp.asarray, ops)))
    res = world.run(torch_world.call, "xeinsum", spec, list(ops), {"in_specs": in_specs})
    for r in res:
        np.testing.assert_allclose(r["full"], single, atol=1e-4, rtol=1e-4, err_msg=msg)


# ------------------------------------------- sharded vs single-device
@pytest.mark.parametrize("chunk", _chunks(N_PAIRWISE // 2))
def test_sharded_pairwise_matches_single_device(chunk, world):
    for i in range(chunk * CHUNK, min((chunk + 1) * CHUNK, N_PAIRWISE // 2)):
        rng = np.random.default_rng([SEED, i])  # same specs as single-device
        cs, dims = gen_pairwise(rng)
        A, B = operands_for((cs.a_modes, cs.b_modes), dims, rng)
        spec = cs.spec_str()
        shard, in_specs = _seeded_shardings(
            (cs.a_modes, cs.b_modes), cs.c_modes, dims, AXES
        )
        _check(world, spec, (A, B), in_specs,
               f"spec #{i} {spec} dims={dims} shard={shard}")


@pytest.mark.parametrize("chunk", _chunks(N_NARY // 2))
def test_sharded_nary_matches_single_device(chunk, world):
    for i in range(chunk * CHUNK, min((chunk + 1) * CHUNK, N_NARY // 2)):
        rng = np.random.default_rng([SEED, 10_000 + i])
        spec, dims = gen_nary(rng)
        lhs = spec.split("->")[0].split(",")
        _, output = parse_nary(spec)
        ops = operands_for(lhs, dims, rng)
        shard, in_specs = _seeded_shardings(lhs, output, dims, AXES)
        _check(world, spec, ops, in_specs,
               f"spec #{i} {spec} dims={dims} shard={shard}")
