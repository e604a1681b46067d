"""Empirical autotuner + persistent dispatch cache for the port's
contractions.

The paper's Figs. 5–8 show the fastest evaluation mode for a contraction
is shape-dependent and not reliably predicted by static rules; on the
card the port's kernel and the library GEMMs each win somewhere.  This
subsystem closes the loop empirically:

:mod:`repro_torch.tuning.candidates` — enumerate legal (strategy ×
    backend × brick depth) executions of a spec;
:mod:`repro_torch.tuning.measure`    — warmup + median-of-k timing (device
    time behind a sleeping kernel on a card);
:mod:`repro_torch.tuning.cache`      — persistent JSON store (canonical
    keys, atomic writes, versioned schema, corruption-tolerant loads; the
    JAX package's format);
:mod:`repro_torch.tuning.model`      — learned cost model fitted on the
    cache's measurements;
:mod:`repro_torch.tuning.federate`   — cross-machine cache merge/import
    (``python -m repro_torch.tuning.federate merge a.json b.json -o f.json``);
:mod:`repro_torch.tuning.drift`      — drift detection and re-measurement;
:mod:`repro_torch.tuning.dispatch`   — ``tuned_contract`` /
    :class:`Dispatcher` tying them together under a :data:`TuningPolicy`
    (off / cached / measure / predict).

Entry points upward: ``contract(..., strategy="tuned")``,
``xeinsum(..., optimize="tuned")`` and ``hooi(..., strategy="tuned")``.
"""

from repro_torch.tuning.cache import (
    SCHEMA_VERSION,
    TuningCache,
    canonical_key,
    valid_entry,
)
from repro_torch.tuning.candidates import (
    Candidate,
    enumerate_candidates,
    validate_tiles,
)
from repro_torch.tuning.dispatch import (
    Dispatcher,
    TuningPolicy,
    default_cache_path,
    get_dispatcher,
    set_dispatcher,
    tuned_contract,
)
from repro_torch.tuning.federate import (
    FederationError,
    import_into,
    merge_entries,
    merge_payloads,
    pick_best,
)
from repro_torch.tuning.measure import Measurement, measure_candidate, time_callable
from repro_torch.tuning.model import CostModel, Prediction, model_for

__all__ = [
    "SCHEMA_VERSION",
    "TuningCache",
    "canonical_key",
    "valid_entry",
    "Candidate",
    "enumerate_candidates",
    "validate_tiles",
    "Dispatcher",
    "TuningPolicy",
    "default_cache_path",
    "get_dispatcher",
    "set_dispatcher",
    "tuned_contract",
    "FederationError",
    "import_into",
    "merge_entries",
    "merge_payloads",
    "pick_best",
    "Measurement",
    "measure_candidate",
    "time_callable",
    "CostModel",
    "Prediction",
    "model_for",
]
