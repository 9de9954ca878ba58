"""Distribution layer: logical-axis sharding rules, resolved to DTensor
placements over a ``DeviceMesh``.

The subsystem has one module, ``repro_torch.dist.sharding``; this package
re-exports the public surface so call sites can use either
``from repro_torch.dist import sharding as shd`` or
``from repro_torch.dist import shard``.
"""
from repro_torch.dist.sharding import (
    PartitionSpec,
    ShardingRules,
    current_sharding,
    decode_rules,
    describe,
    mesh_shape,
    placements_for,
    pspec_for,
    replicated_rules,
    rules_for,
    rules_for_platform,
    shard,
    train_rules,
    use_sharding,
    validate_rules,
)

__all__ = [
    "PartitionSpec",
    "ShardingRules",
    "current_sharding",
    "decode_rules",
    "describe",
    "mesh_shape",
    "placements_for",
    "pspec_for",
    "replicated_rules",
    "rules_for",
    "rules_for_platform",
    "shard",
    "train_rules",
    "use_sharding",
    "validate_rules",
]
