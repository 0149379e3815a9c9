"""Distributed: the fault-tolerant training runner (one card).  The
sharded layer (context, sharding, collectives, hetero) waits for its port."""
from .elastic import FaultTolerantRunner, RunnerConfig, StepFailure

__all__ = ["FaultTolerantRunner", "RunnerConfig", "StepFailure"]
