"""Tucker decomposition via HOOI — the paper's application study (§II-C, Fig 9).

Algorithm 1 of the paper, for a third-order tensor ``T ∈ R^{m×n×p}``::

    T_mnp ≈ G_ijk A_mi B_nj C_pk

The multi-operand expressions (Y-updates, core computation and
reconstruction) go through :mod:`repro_torch.core.program` /
:func:`repro_torch.core.einsum.xeinsum`, which plan the pairwise order and
lower each step through the engine — ``strategy="auto"`` (flatten or
strided-batch, no copies) with ``backend="kernel"`` for the paper's
method on the hand-written kernel, ``backend="torch"`` for library GEMMs,
or ``strategy="conventional"`` for the matricization baseline the paper
benchmarks against (TensorToolbox / BTAS / Cyclops all transpose+copy).
Everything computes on ``T``'s device.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.contract import contract
from repro_torch.core.einsum import xeinsum
from repro_torch.core.program import build_program, compile_program

__all__ = ["TuckerResult", "hooi", "tucker_reconstruct", "init_hosvd"]


@dataclasses.dataclass
class TuckerResult:
    core: torch.Tensor       # G (i, j, k)
    factors: tuple           # A (m,i), B (n,j), C (p,k)
    rel_error: torch.Tensor  # ||T - reconstruction|| / ||T||


def _top_eigvecs(gram, r: int):
    """The ``r`` leading eigenvectors of a symmetric Gram matrix, largest
    eigenvalue first (``eigh`` sorts ascending)."""
    _, vecs = torch.linalg.eigh(gram)
    return vecs.flip(-1)[:, :r]


def init_hosvd(T, ranks, strategy: str = "auto", backend: str = "torch"):
    """HOSVD init: factor r = leading left SVs of each unfolding (Alg 1 l.2),
    as the top eigenvectors of the unfoldings' Gram matrices — built by
    contractions instead of transposing T (transpose-free init)."""
    m, n, p = T.shape
    i, j, k = ranks
    t1 = T.reshape(m, n * p)
    A = _top_eigvecs(t1 @ t1.T, i)
    B = _top_eigvecs(contract("mnp,mqp->nq", T, T, strategy="direct"), j)
    C = _top_eigvecs(contract("mnp,mnq->pq", T, T, strategy="direct"), k)
    return A, B, C


def hooi(
    T,
    ranks: tuple[int, int, int],
    *,
    n_iter: int = 10,
    strategy: Literal["auto", "batched", "conventional", "direct", "tuned"] = "auto",
    backend: Literal["torch", "kernel"] = "torch",
    jit: bool = True,
) -> TuckerResult:
    """Higher-order orthogonal iteration (paper Algorithm 1).

    The body's recurring contraction working set is compiled **once** as
    three :mod:`repro_torch.core.program` contraction programs (the split
    follows the data dependencies — each factor update consumes the
    eigendecomposition of the previous one) and executed per iteration
    from the program cache.  ``jit`` is accepted for signature parity
    with the JAX package and ignored: PyTorch executes eagerly.
    """
    del jit
    i, j, k = ranks
    A, B, C = init_hosvd(T, ranks, strategy, backend)
    kw = dict(strategy=strategy, backend=backend)
    # Y_mjk = T_mnp B_nj C_pk (Alg 1 l.4), its gram Y_(1)·Y_(1)ᵀ (leading
    # left SVs = top eigvecs — no unfolding transpose is ever
    # materialized), and the dominant T·C stage staged explicitly so the
    # Y_(1) and Y_(2) updates share it: one program, two outputs.
    p1 = compile_program(build_program(
        {"T": T, "C": C, "B": B},
        [("t1", "mnp,pk->mnk", ("T", "C")),
         ("y1", "mnk,nj->mjk", ("t1", "B")),
         ("g1", "mjk,qjk->mq", ("y1", "y1"), {"strategy": "direct"})],
        outputs=("g1", "t1")), **kw)
    # Y_ink = T_mnp A_mi C_pk (l.6), via the shared t1 (a shape-only input)
    t1_aval = torch.empty((T.shape[0], T.shape[1], k), dtype=T.dtype,
                          device="meta")
    p2 = compile_program(build_program(
        {"t1": t1_aval, "A": A},
        [("y2", "mnk,mi->ink", ("t1", "A")),
         ("g2", "ink,iqk->nq", ("y2", "y2"), {"strategy": "direct"})]), **kw)
    # Y_ijp = T_mnp A_mi B_nj (l.8) — no shared stage; path-planned
    p3 = compile_program(build_program(
        {"T": T, "A": A, "B": B},
        [("y3", "mnp,mi,nj->ijp", ("T", "A", "B")),
         ("g3", "ijp,ijq->pq", ("y3", "y3"), {"strategy": "direct"})]), **kw)

    for _ in range(n_iter):
        g1, t1 = p1(T, C, B)
        A = _top_eigvecs(g1, i)
        B = _top_eigvecs(p2(t1, A), j)
        C = _top_eigvecs(p3(T, A, B), k)

    # G_ijk = T ×1 Aᵀ ×2 Bᵀ ×3 Cᵀ — one four-operand expression
    G = xeinsum("mnp,mi,nj,pk->ijk", T, A, B, C, **kw)

    recon = tucker_reconstruct(G, (A, B, C), **kw)
    rel = torch.linalg.norm(T - recon) / torch.linalg.norm(T)
    return TuckerResult(core=G, factors=(A, B, C), rel_error=rel)


def tucker_reconstruct(G, factors, *, strategy="auto", backend="torch"):
    """``T ≈ G ×1 A ×2 B ×3 C`` as one path-planned n-ary contraction."""
    A, B, C = factors
    return xeinsum(
        "ijk,mi,nj,pk->mnp", G, A, B, C, strategy=strategy, backend=backend
    )
