"""The port of ``repro.distributed``.

* :mod:`~repro_torch.distributed.sharding` — ``PartitionSpec`` (``P``),
  ``specs_equal``, the logical-axis ``ShardingRules`` and the DTensor
  placements of a spec;
* :mod:`~repro_torch.distributed.contract` — sharded pairwise contraction
  over a ``DeviceMesh`` (``plan_sharded``, ``sharded_contract``): local
  kernels per shard, explicit collectives;
* :mod:`~repro_torch.distributed.compress` — the gradient compressors the
  trainer applies.

Still to come (ROADMAP.md item 12): the sharded trainer and server and
the models' ``logical`` annotations (12a), MoE all-to-all and pipeline
stages (12c).
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
    P,
    PartitionSpec,
    ShardingRules,
    current_rules,
    local_block,
    logical,
    named_sharding,
    placements,
    spec_of,
    specs_equal,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "P",
    "PartitionSpec",
    "ShardedPlan",
    "ShardingRules",
    "as_dtensor",
    "current_rules",
    "local_block",
    "local_dims",
    "logical",
    "named_sharding",
    "placements",
    "plan_sharded",
    "resolve_mode_axes",
    "sharded_contract",
    "spec_of",
    "specs_equal",
    "use_rules",
]
