"""Distribution layer: counterpart of `repro.dist` — logical-axis
sharding rules and specs (`sharding`), the collectives the port issues
(`collectives`), tensor-parallel compute on each rank's blocks
(`parallel`), and ranks started as processes (`spawn`)."""

from .sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    current_context,
    local_block,
    params_partition_specs,
    place_tree,
    shard,
    sharding_rules,
)

__all__ = [
    "SERVE_RULES", "TRAIN_RULES", "current_context", "local_block",
    "params_partition_specs", "place_tree", "shard", "sharding_rules",
]
