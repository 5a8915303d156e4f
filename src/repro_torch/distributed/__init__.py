"""Sharding rules and the per-rank program of a data mesh."""
from .data_parallel import DataParallel
from .sharding import (ACT_RULES, ACT_RULES_SEQ_SHARDED, PARAM_RULES,
                       ShardingRules, act_sharding, constrain,
                       logical_to_spec, param_sharding)

__all__ = ["ACT_RULES", "ACT_RULES_SEQ_SHARDED", "PARAM_RULES",
           "DataParallel", "ShardingRules", "act_sharding", "constrain",
           "logical_to_spec", "param_sharding"]
