"""Distribution layer: logical-axis sharding rules (single-card port)."""
from repro_torch.dist.sharding import (
    ShardingRules,
    current_sharding,
    decode_rules,
    replicated_rules,
    rules_for,
    rules_for_platform,
    shard,
    train_rules,
    use_sharding,
)

__all__ = [
    "ShardingRules",
    "current_sharding",
    "decode_rules",
    "replicated_rules",
    "rules_for",
    "rules_for_platform",
    "shard",
    "train_rules",
    "use_sharding",
]
