"""Sharding: the rules that map parameters, activations and caches to mesh
axes (:mod:`.rules`), and the collectives the sharded layers call
(:mod:`.collectives`).  Counterpart of ``repro/sharding``."""
from repro_torch.sharding.rules import (
    ShardingRules,
    Spec,
    current_rules,
    param_specs,
    shard_act,
    use_rules,
    zero1_specs,
)

__all__ = [
    "ShardingRules",
    "Spec",
    "current_rules",
    "param_specs",
    "shard_act",
    "use_rules",
    "zero1_specs",
]
