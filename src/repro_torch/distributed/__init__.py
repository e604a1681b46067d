"""The port of ``repro.distributed``.

* :mod:`~repro_torch.distributed.sharding` — ``PartitionSpec`` (``P``),
  ``specs_equal``, the logical-axis ``ShardingRules``, the DTensor
  placements of a spec, ``NamedSharding`` and ``device_put``;
* :mod:`~repro_torch.distributed.contract` — sharded pairwise contraction
  over a ``DeviceMesh`` (``plan_sharded``, ``sharded_contract``): local
  kernels per shard, explicit collectives;
* :mod:`~repro_torch.distributed.moe_a2a` — expert parallelism through a
  fixed-capacity all-to-all (``moe_ffn_a2a``, ``pad_expert_params``), the
  models' ``moe_impl="a2a"`` path under sharding rules;
* :mod:`~repro_torch.distributed.pipeline` — GPipe stages over a mesh
  axis (``pipeline_forward``, ``pipeline_loss``);
* :mod:`~repro_torch.distributed.compress` — the gradient compressors the
  trainer applies.

The sharded trainer and server (``Trainer(rules=)``,
``ServingRuntime(mesh=)``) place their trees with these and
:mod:`repro_torch.launch.shardings`.
"""

from repro_torch.distributed.contract import (
    ShardedPlan,
    as_dtensor,
    local_dims,
    plan_sharded,
    resolve_mode_axes,
    sharded_contract,
)
from repro_torch.distributed.moe_a2a import moe_ffn_a2a, pad_expert_params
from repro_torch.distributed.pipeline import pipeline_forward, pipeline_loss
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
    "moe_ffn_a2a",
    "named_sharding",
    "pad_expert_params",
    "pipeline_forward",
    "pipeline_loss",
    "placements",
    "plan_sharded",
    "reduce_partial",
    "resolve_mode_axes",
    "sharded_contract",
    "spec_of",
    "specs_equal",
    "use_rules",
]
