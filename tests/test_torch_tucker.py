"""The port's Tucker HOOI and CP-ALS (``core/tucker.py``, ``core/cp.py``)
against the JAX package's, on the same numpy tensor."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cp import cp_als as jcp_als
from repro.core.tucker import hooi as jhooi
from repro.core.tucker import tucker_reconstruct as jtucker_reconstruct
from repro_torch.core.cp import cp_als
from repro_torch.core.tucker import TuckerResult, hooi, tucker_reconstruct
from repro_torch.interop import from_numpy

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()

SHAPE, RANKS = (20, 18, 16), (4, 3, 5)


def _low_rank_plus_noise(seed, shape, ranks, noise=0.05):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal(ranks)
    A, B, C = (np.linalg.qr(rng.standard_normal((d, r)))[0] for d, r in zip(shape, ranks))
    T = np.einsum("ijk,mi,nj,pk->mnp", G, A, B, C)
    return (T + noise * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tensor():
    return _low_rank_plus_noise(0, SHAPE, RANKS)


@pytest.mark.parametrize("strategy", ["auto", "batched", "conventional"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_hooi_matches_jax(tensor, strategy, backend):
    jbackend = {"torch": "xla", "kernel": "pallas"}[backend]
    want = jhooi(jnp.asarray(tensor), RANKS, n_iter=4, strategy=strategy, backend=jbackend)
    got = hooi(torch.from_numpy(tensor), RANKS, n_iter=4, strategy=strategy, backend=backend)
    assert abs(float(got.rel_error) - float(want.rel_error)) < 1e-5
    assert tuple(got.core.shape) == RANKS
    # eigenvector signs are arbitrary: compare the projectors A·Aᵀ
    for f, jf in zip(got.factors, want.factors):
        jf = np.asarray(jf)
        np.testing.assert_allclose((f @ f.T).numpy(), jf @ jf.T, atol=1e-4)


def test_tucker_reconstruct_of_jax_factors(tensor):
    """JAX's result crosses into the port through ``interop.from_numpy``
    (no JAX import on the port's side) and reconstructs the same tensor."""
    res = jhooi(jnp.asarray(tensor), RANKS, n_iter=2)
    want = np.asarray(jtucker_reconstruct(res.core, res.factors))
    as_numpy = TuckerResult(core=np.asarray(res.core),
                            factors=tuple(np.asarray(f) for f in res.factors),
                            rel_error=np.asarray(res.rel_error))
    ported = from_numpy(as_numpy, device="cpu")
    assert isinstance(ported, TuckerResult)
    assert all(isinstance(getattr(ported, f.name), (torch.Tensor, tuple))
               for f in dataclasses.fields(ported))
    for backend in ("torch", "kernel"):
        got = tucker_reconstruct(ported.core, ported.factors, backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(ported.rel_error) == float(res.rel_error)


def test_cp_als_matches_jax():
    rng = np.random.default_rng(4)
    A, B, C = (rng.standard_normal((d, 3)) for d in (15, 12, 10))
    T = np.einsum("mr,nr,pr->mnp", A, B, C).astype(np.float32)
    want = jcp_als(jnp.asarray(T), 3, n_iter=20)
    got = cp_als(torch.from_numpy(T), 3, n_iter=20)
    assert abs(float(got.rel_error) - float(want.rel_error)) < 1e-4
    # each column's sign is arbitrary (it follows the eigenvectors of the
    # init): align it before comparing
    for f, jf in zip(got.factors, want.factors):
        f, jf = f.numpy(), np.asarray(jf)
        np.testing.assert_allclose(f * np.sign((f * jf).sum(0)), jf, atol=1e-4)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-4)
