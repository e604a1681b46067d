"""Learned cost model over the tuning cache (Peise et al., arXiv:1409.8608).

A serving fleet sees thousands of (spec, dims, dtype) buckets; the
empirical autotuner only knows the ones it has measured.  Peise et al.
observe that BLAS-kernel timings compose predictably across shapes —
the cache's accumulated measurements are exactly the training set for a
predictor that picks winners on *unseen* shapes.

Each cached ``(canonical key, candidate)`` pair is featurized from the
analytic plan (roles, flattened dims), what the candidate runs, the
dtype width, and the roofline attribution (flops / bytes / intensity via
:func:`repro_torch.obs.roofline.contraction_record`).  A ``torch``
candidate featurizes exactly as the JAX package's ``xla`` candidate of
the same name; a ``kernel`` candidate carries, in place of the Pallas
tile sizes, the route ``native_gemm`` takes for it
(:func:`repro_torch.kernels.sb_gemm.native_plan` on contiguous operands)
and its walk depth.  Per candidate *family*
(``backend:strategy``) two regressors are fit on **log** median µs:

* a closed-form **ridge** regression (captures the power-law trend —
  log-time is near-linear in log-flops/log-bytes);
* a **k-NN** interpolant over the standardized feature space (captures
  the local shape-dependent winner flips ridge smooths over).

The prediction blends them by *confidence* — a training-neighborhood
density score ``exp(-mean distance to the k nearest training rows)``:
near the training set the k-NN interpolation dominates (and confidence
is high), far away ridge extrapolates (and confidence is low, so the
dispatcher falls back to measurement).  Entries flagged ``"predicted"``
(written by the ``"predict"`` policy itself) are **excluded** from
training — the model never eats its own guesses.

Entry points: :meth:`CostModel.from_cache` and
:meth:`CostModel.predict`; :func:`model_for` memoizes one fitted model
per cache fingerprint so the dispatcher refits only when the cache
actually changed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import torch

from repro_torch.core.notation import CaseKind, ContractionSpec, parse_spec
from repro_torch.core.planner import make_plan
from repro_torch.kernels.ops import EXT_BATCH_TILE, plan_roles
from repro_torch.kernels.sb_gemm import ROUTES, native_plan

__all__ = [
    "CONFIDENCE_THRESHOLD",
    "KNN_K",
    "RIDGE_LAMBDA",
    "MIN_FAMILY_ROWS",
    "Prediction",
    "CostModel",
    "featurize",
    "parse_cache_key",
    "model_for",
]

#: default confidence gate for the ``"predict"`` policy: below it the
#: dispatcher measures (or falls back to analytic under jit/"cached").
CONFIDENCE_THRESHOLD = 0.5

#: neighbors used for both the k-NN interpolant and the density score.
KNN_K = 3

#: ridge regularizer (features are standardized, so one scale fits all).
RIDGE_LAMBDA = 1e-2

#: a family with fewer training rows than this is not predictable — its
#: candidates are priced by ridge over *all* families' pooled rows would
#: be guesswork, so they are simply skipped (and if no family survives,
#: ``predict`` returns ``None``).
MIN_FAMILY_ROWS = 3


def parse_cache_key(key: str):
    """Invert :func:`repro_torch.tuning.cache.canonical_key`.

    Returns ``(ContractionSpec, dims, dtype_name, platform)`` or ``None``
    for keys that do not parse (foreign/hand-edited caches must never
    crash the model fit — they are just not training data).
    """
    parts = key.split("|")
    if len(parts) != 4:
        return None
    cspec, sig, dtype_name, platform = parts
    try:
        cs = parse_spec(cspec)
    except (ValueError, KeyError):
        return None
    order = list(dict.fromkeys(cs.a_modes + cs.b_modes + cs.c_modes))
    sizes = [s for s in sig.split("x") if s]
    if len(sizes) != len(order):
        return None
    try:
        dims = {m: int(s) for m, s in zip(order, sizes)}
    except ValueError:
        return None
    return cs, dims, dtype_name, platform


_KIND_ORDER = (
    CaseKind.FLAT_GEMM, CaseKind.SB_GEMM, CaseKind.EXCEPTIONAL, CaseKind.NESTED,
)

#: the ``native_gemm`` routes a kernel candidate's features flag, one
#: indicator each; the fbatched route (every product the others do not
#: take) is the all-zero baseline, and the batched and gathered routes set
#: the wgmma indicator (all three are the bf16 tensor-core routes), so the
#: kernel features stay 4 wide, the JAX package's 4 tile log2s
_ROUTE_FLAGS = ("stream", "splitk", "wgmma")
_FLAG_OF = {"batched": "wgmma", "gathered": "wgmma"}
assert set(ROUTES) == {*_ROUTE_FLAGS, *_FLAG_OF, "fbatched"}

#: feature vector layout (kept in one place so train and predict can
#: never skew): 8 roofline/structure + kind one-hot + 3 plan flags +
#: 4 role extents + 4 kernel features (route indicators, log2 walk) +
#: padding waste + transpose count — the JAX package's layout, with the
#: kernel features in the place of its 4 tile log2s; see :func:`featurize`.
N_FEATURES = 8 + len(_KIND_ORDER) + 3 + 4 + len(_ROUTE_FLAGS) + 1 + 1 + 1


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def kernel_route(cs: ContractionSpec, dims: dict, dtype, candidate) -> tuple[str, int]:
    """(route, walk) of the ``native_gemm`` launch a ``kernel`` candidate
    makes on contiguous operands of ``cs`` at ``dims``: the planning
    strategies launch on the plan's flattened modes (the native route
    where the plan has no role lowering), ``native`` on the spec as given.
    """
    dt = getattr(torch, str(dtype).removeprefix("torch."))
    spec, fdims, walk = cs, dims, 1
    if candidate.strategy != "native":
        plan = make_plan(cs, dims, allow_flatten=candidate.strategy == "auto")
        if plan_roles(plan) is not None:
            spec, fdims = plan.fspec, plan.fdims
            if plan.sb_batch:
                walk = candidate.tiles_dict.get(
                    "b", EXT_BATCH_TILE if plan.kind == CaseKind.EXCEPTIONAL else 1)
    A = _meta([fdims[m] for m in spec.a_modes], dt)
    B = _meta([fdims[m] for m in spec.b_modes], dt)
    route, _ = native_plan(A, B, a_modes=spec.a_modes, b_modes=spec.b_modes,
                           c_modes=spec.c_modes, dims=fdims)
    return route, walk


def featurize(cs, dims: dict, dtype, candidate, *, transposes=None) -> np.ndarray:
    """Feature vector for one ``(contraction, candidate)`` pair.

    Everything here is *analytic* — computable identically for a cached
    measurement (training) and for a never-seen shape (prediction):

    * roofline attribution: log flops, log bytes, log(1+intensity),
      dtype width (:func:`repro_torch.obs.roofline.contraction_record`);
    * structure: mode counts of A/B/C, contracted count, plan kind
      one-hot, sb-batch/nested/copies flags from the analytic plan;
    * role extents: log2 size of the u/v/k/b modes under the plan's
      role assignment (0 where the plan has no such role);
    * what the candidate runs: for ``kernel`` candidates an indicator
      of each ``native_gemm`` route but ``fbatched`` (all zero there;
      ``batched`` and ``gathered`` set the ``wgmma`` indicator) and log2
      of the candidate's ``b`` tile as the JAX package's tile log2 (the
      walk :func:`kernel_route` gives; 0 without one); zeros for ``torch``
      candidates;
    * padding waste, always 0 (the kernel masks ragged edges; the column
      keeps the JAX package's layout), and the candidate's transpose
      count (the stored copy audit when the cache has one, else the
      plan's analytic copy flag).
    """
    from repro_torch.obs.roofline import contraction_record

    rec = contraction_record(cs, dims, dtype)
    feats = [
        math.log1p(rec["flops"]),
        math.log1p(rec["bytes"]),
        math.log1p(rec["intensity"]),
        float(getattr(torch, str(dtype).removeprefix("torch.")).itemsize),
        float(len(cs.a_modes)),
        float(len(cs.b_modes)),
        float(len(cs.c_modes)),
        float(len(cs.contracted)),
    ]

    plan = roles = None
    if cs.c_modes and cs.a_modes and cs.b_modes:
        try:
            plan = make_plan(cs, dims)
            roles = plan_roles(plan)
        except (ValueError, KeyError):
            plan = roles = None
    for kind in _KIND_ORDER:
        feats.append(1.0 if plan is not None and plan.kind == kind else 0.0)
    feats.append(1.0 if plan is not None and plan.sb_batch else 0.0)
    feats.append(float(len(plan.nested)) if plan is not None else 0.0)
    feats.append(1.0 if plan is not None and plan.copies not in ("", "none")
                 else 0.0)
    # role extents in the *flattened* dims (what the kernel actually sees)
    role_dims = {}
    if plan is not None and roles:
        for mode, role in roles.items():
            role_dims[role] = plan.fdims[mode]
    feats.append(math.log2(role_dims.get("u", 1)) if role_dims.get("u") else 0.0)

    for role in ("v", "k", "b"):
        d = role_dims.get(role)
        feats.append(math.log2(d) if d else 0.0)
    if candidate.backend == "kernel" and plan is not None:
        route, walk = kernel_route(cs, dims, dtype, candidate)
        flag = _FLAG_OF.get(route, route)
        feats.extend(1.0 if flag == r else 0.0 for r in _ROUTE_FLAGS)
        feats.append(math.log2(walk))
    else:
        feats.extend([0.0] * (len(_ROUTE_FLAGS) + 1))
    feats.append(0.0)   # padding waste: none in the port

    if transposes is None:
        transposes = (
            1.0 if plan is not None and plan.copies not in ("", "none") else 0.0
        )
    feats.append(float(transposes))
    assert len(feats) == N_FEATURES
    return np.asarray(feats, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One model verdict for an unseen contraction."""

    candidate: object               # winning repro_torch.tuning.candidates.Candidate
    us: float                       # predicted median µs of the winner
    confidence: float               # training-neighborhood density in [0, 1]
    per_candidate: dict             # candidate key -> predicted µs (all families)


class _FamilyModel:
    """Ridge + k-NN over one candidate family's standardized features."""

    def __init__(self, X: np.ndarray, y: np.ndarray):
        self.mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd[sd == 0.0] = 1.0          # constant feature: distance contribution 0
        self.sd = sd
        self.X = (X - self.mu) / self.sd
        self.y = y                   # log µs
        n, d = self.X.shape
        A = np.hstack([self.X, np.ones((n, 1))])
        reg = RIDGE_LAMBDA * np.eye(d + 1)
        reg[-1, -1] = 0.0            # never shrink the intercept
        self.w = np.linalg.solve(A.T @ A + reg, A.T @ y)

    def _z(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mu) / self.sd

    def predict(self, x: np.ndarray) -> tuple[float, float]:
        """(predicted log µs, confidence) for one raw feature vector."""
        z = self._z(x)
        ridge = float(np.append(z, 1.0) @ self.w)
        d = np.sqrt(((self.X - z) ** 2).sum(axis=1) / z.size)
        k = min(KNN_K, d.size)
        idx = np.argsort(d)[:k]
        dk, yk = d[idx], self.y[idx]
        knn = float(np.average(yk, weights=1.0 / (dk + 1e-6)))
        conf = float(math.exp(-float(dk.mean())))
        # near the training set the interpolant wins; far away, ridge
        return conf * knn + (1.0 - conf) * ridge, conf


class CostModel:
    """Per-family regressors fitted over one cache's measured entries."""

    def __init__(self, families: dict[str, _FamilyModel], platform: str,
                 n_rows: int):
        self.families = families
        self.platform = platform
        self.n_rows = n_rows

    @classmethod
    def from_cache(cls, cache, *, platform: str | None = None) -> "CostModel":
        """Fit on every *measured* entry for ``platform`` (default:
        :func:`~repro_torch.tuning.cache.default_platform`).  Predicted
        entries are skipped — see module doc.  An empty or foreign cache
        yields a model with no families, whose :meth:`predict` returns
        ``None`` for everything.
        """
        from repro_torch.tuning.cache import default_platform
        from repro_torch.tuning.candidates import Candidate

        platform = platform or default_platform()
        rows: dict[str, list] = {}
        for key, entry in cache.entries.items():
            if entry.get("predicted"):
                continue
            parsed = parse_cache_key(key)
            if parsed is None:
                continue
            cs, dims, dtype_name, plat = parsed
            if plat != platform:
                continue
            stored_t = entry.get("transposes") or {}
            for ckey, us in entry["results"].items():
                if not (isinstance(us, (int, float)) and us > 0):
                    continue
                try:
                    cand = Candidate.from_key(ckey)
                except (ValueError, TypeError):
                    continue
                fam = f"{cand.backend}:{cand.strategy}"
                x = featurize(cs, dims, dtype_name, cand,
                              transposes=stored_t.get(ckey))
                rows.setdefault(fam, []).append((x, math.log(us)))
        families = {}
        n_rows = 0
        for fam, rs in rows.items():
            n_rows += len(rs)
            if len(rs) < MIN_FAMILY_ROWS:
                continue
            X = np.stack([x for x, _ in rs])
            y = np.asarray([t for _, t in rs])
            families[fam] = _FamilyModel(X, y)
        return cls(families, platform, n_rows)

    # ------------------------------------------------------------- predict
    def predict(self, spec, dims: dict, dtype, *,
                backends: tuple[str, ...] | None = None) -> Prediction | None:
        """Pick the predicted-fastest candidate for an unseen shape.

        Enumerates the same legal candidate set the measuring tuner
        would (:func:`repro_torch.tuning.candidates.enumerate_candidates`),
        prices each through its family regressor, and returns the
        arg-min with the candidate-set's mean neighborhood confidence.
        Candidates whose family has no fitted regressor are skipped;
        ``None`` when *no* candidate is predictable.
        """
        from repro_torch.tuning.candidates import enumerate_candidates

        cs = parse_spec(spec) if isinstance(spec, str) else spec
        if not self.families:
            return None
        cands = enumerate_candidates(cs, dims, backends=backends)
        per: dict[str, float] = {}
        confs: list[float] = []
        best = None
        for cand in cands:
            fam = f"{cand.backend}:{cand.strategy}"
            fm = self.families.get(fam)
            if fm is None:
                continue
            log_us, conf = fm.predict(featurize(cs, dims, dtype, cand))
            us = math.exp(log_us)
            per[cand.key()] = us
            confs.append(conf)
            if best is None or us < best[1]:
                best = (cand, us)
        if best is None:
            return None
        return Prediction(
            candidate=best[0], us=best[1],
            confidence=float(np.mean(confs)), per_candidate=per,
        )

    def predict_us(self, spec, dims: dict, dtype,
                   *, min_confidence: float = 0.0) -> float | None:
        """Predicted winner µs, or ``None`` below ``min_confidence`` —
        the :func:`repro_torch.tuning.dispatch.path_cost` pricing hook."""
        p = self.predict(spec, dims, dtype)
        if p is None or p.confidence < min_confidence:
            return None
        return p.us


# ------------------------------------------------------- per-cache memoization
_MEMO: dict[int, tuple[tuple, CostModel]] = {}


def model_for(cache, *, platform: str | None = None) -> CostModel:
    """The fitted :class:`CostModel` for ``cache``, refit only when its
    :meth:`~repro_torch.tuning.cache.TuningCache.fingerprint` changed (every
    ``put`` bumps it, so a predict-policy dispatcher that just recorded a
    predicted entry refits — and the refit skips predicted entries)."""
    fp = cache.fingerprint()
    hit = _MEMO.get(id(cache))
    if hit is not None and hit[0] == fp:
        return hit[1]
    model = CostModel.from_cache(cache, platform=platform)
    _MEMO[id(cache)] = (fp, model)
    return model
