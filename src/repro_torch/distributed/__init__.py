"""Distributed: the fault-tolerant training runner (one card) and the
POAS heterogeneous data-parallel batch split (``hetero``).  The sharded
layer (context, sharding, collectives) waits for its port."""
from .elastic import FaultTolerantRunner, RunnerConfig, StepFailure
from .hetero import HeteroBatchScheduler, PodProfile, TrainStepDomain

__all__ = ["FaultTolerantRunner", "RunnerConfig", "StepFailure",
           "HeteroBatchScheduler", "PodProfile", "TrainStepDomain"]
