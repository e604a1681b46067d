"""The port of ``repro.distributed``.

* :mod:`~repro_torch.distributed.sharding` — ``PartitionSpec`` (``P``),
  ``specs_equal``, the logical-axis ``ShardingRules``, the DTensor
  placements of a spec, ``NamedSharding`` and ``device_put``;
* :mod:`~repro_torch.distributed.contract` — sharded pairwise contraction
  over a ``DeviceMesh`` (``plan_sharded``, ``sharded_contract``): local
  kernels per shard, explicit collectives;
* :mod:`~repro_torch.distributed.compress` — the gradient compressors the
  trainer applies.

The sharded trainer and server (``Trainer(rules=)``,
``ServingRuntime(mesh=)``) place their trees with these and
:mod:`repro_torch.launch.shardings`.  Still to come (ROADMAP.md queue 1,
item 12c): MoE all-to-all and pipeline stages.
"""

from repro_torch.distributed.contract import (
    ShardedPlan,
    as_dtensor,
    local_dims,
    plan_sharded,
    resolve_mode_axes,
    sharded_contract,
)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    P,
    PartitionSpec,
    ShardingRules,
    current_rules,
    device_put,
    local_block,
    logical,
    named_sharding,
    placements,
    reduce_partial,
    spec_of,
    specs_equal,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardedPlan",
    "ShardingRules",
    "as_dtensor",
    "current_rules",
    "device_put",
    "local_block",
    "local_dims",
    "logical",
    "named_sharding",
    "placements",
    "plan_sharded",
    "reduce_partial",
    "resolve_mode_axes",
    "sharded_contract",
    "spec_of",
    "specs_equal",
    "use_rules",
]
