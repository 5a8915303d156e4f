"""Sharding rules and the per-rank program of a mesh: the data and pod
axes (``data_parallel``) and the model axis (``tensor_parallel``)."""
from .data_parallel import DataParallel
from .sharding import (ACT_RULES, ACT_RULES_SEQ_SHARDED, PARAM_RULES,
                       ShardingRules, act_sharding, constrain,
                       logical_to_spec, param_sharding)
from .tensor_parallel import TensorParallel

__all__ = ["ACT_RULES", "ACT_RULES_SEQ_SHARDED", "PARAM_RULES",
           "DataParallel", "ShardingRules", "TensorParallel", "act_sharding",
           "constrain", "logical_to_spec", "param_sharding"]
