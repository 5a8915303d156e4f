"""Training on one device: the optimizers, the synthetic data source,
checkpointing, fault tolerance and the train loop, with the JAX package's
names."""
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticSource
from .fault_tolerance import (ElasticPlan, HeartbeatMonitor,
                              StragglerDetector, plan_remesh,
                              recommended_interval)
from .loop import TrainResult, make_train_step, train
from .optimizer import OptimizerConfig, make_optimizer

__all__ = ["CheckpointManager", "DataConfig", "SyntheticSource",
           "ElasticPlan", "HeartbeatMonitor", "StragglerDetector",
           "plan_remesh", "recommended_interval", "TrainResult",
           "make_train_step", "train", "OptimizerConfig", "make_optimizer"]
