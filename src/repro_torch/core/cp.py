"""CP decomposition via ALS — the other decomposition named in paper §II-C.

``T_mnp ≈ Σ_r λ_r · A_mr ∘ B_nr ∘ C_pr``.  The bottleneck kernel is the
MTTKRP (matricized tensor times Khatri-Rao product); it is stated as one
three-operand expression and the path optimizer chooses the pairwise
order — tensor-times-matrix first, or the (tiny) Khatri-Rao factor
``B ⊙ C`` first, whichever the cost model prefers.  No unfolding copies.
Everything computes on ``T``'s device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.contract import contract
from repro_torch.core.einsum import xeinsum
from repro_torch.core.program import compile_program

__all__ = ["CPResult", "cp_als"]


@dataclasses.dataclass
class CPResult:
    weights: torch.Tensor        # λ (r,)
    factors: tuple               # A (m,r), B (n,r), C (p,r)
    rel_error: torch.Tensor


def _nvecs(gram, r: int):
    """Leading ``r`` eigenvectors of a Gram matrix (TensorToolbox 'nvecs')."""
    _, v = torch.linalg.eigh(gram)
    return v.flip(-1)[:, :r]


def _solve(mttkrp, X, Y):
    gram = (X.T @ X) * (Y.T @ Y)
    return torch.linalg.solve(gram.T, mttkrp.T).T


def cp_als(T, rank: int, *, n_iter: int = 25, strategy="auto",
           backend="torch") -> CPResult:
    # HOSVD init: leading eigvecs of each unfolding's Gram matrix, computed
    # as contractions — avoids the random-init ALS swamp.
    A = _nvecs(contract("mnp,qnp->mq", T, T, strategy="direct"), rank)
    B = _nvecs(contract("mnp,mqp->nq", T, T, strategy="direct"), rank)
    C = _nvecs(contract("mnp,mnq->pq", T, T, strategy="direct"), rank)

    # The three MTTKRPs are the sweep's recurring working set: compile each
    # once and execute the same programs every iteration.
    kw = dict(strategy=strategy, backend=backend)
    p_m1 = compile_program("mnp,nr,pr->mr", T, B, C, **kw)   # mode-1 MTTKRP
    p_m2 = compile_program("mnp,mr,pr->nr", T, A, C, **kw)   # mode-2
    p_m3 = compile_program("mnp,mr,nr->pr", T, A, B, **kw)   # mode-3

    for _ in range(n_iter):
        A = _solve(p_m1(T, B, C), B, C)
        B = _solve(p_m2(T, A, C), A, C)
        C = _solve(p_m3(T, A, B), A, B)
    na, nb, nc = (torch.linalg.norm(F, dim=0) for F in (A, B, C))
    lam = na * nb * nc
    An, Bn, Cn = A / na, B / nb, C / nc
    recon = xeinsum("r,mr,nr,pr->mnp", lam, An, Bn, Cn)
    rel = torch.linalg.norm(T - recon) / torch.linalg.norm(T)
    return CPResult(weights=lam, factors=(An, Bn, Cn), rel_error=rel)
