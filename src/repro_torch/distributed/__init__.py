"""Distribution layer: mesh context, sharding rules and their ``DTensor``
placement, compressed collectives, the fault-tolerant runner with
``remesh`` onto a device or a new mesh's shardings, and the POAS
heterogeneous data-parallel batch split (``hetero``)."""
from .context import (batch_axes, constrain, constrain_batch,
                      constrain_tokens, current_mesh, data_shards, fsdp_axis,
                      model_axis_size, use_mesh)
from .elastic import FaultTolerantRunner, RunnerConfig, StepFailure
from .hetero import HeteroBatchScheduler, PodProfile, TrainStepDomain

__all__ = ["batch_axes", "constrain", "constrain_batch", "constrain_tokens",
           "current_mesh", "data_shards", "fsdp_axis", "model_axis_size",
           "use_mesh",
           "FaultTolerantRunner", "RunnerConfig", "StepFailure",
           "HeteroBatchScheduler", "PodProfile", "TrainStepDomain"]
