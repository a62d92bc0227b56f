"""Fault tolerance: durable checkpoint files (``checkpoint.py``),
deterministic fault injection (``faults.py``), the retry policy
(``retry.py``), self-healing gangs (``supervisor.py``:
:class:`ClusterSupervisor` detects a worker's death or stall, tears the
gang down, respawns it from the newest verified checkpoint under a
per-slot restart budget, and shrinks or halts past it), the elastic
resize state machine the supervisor drives (``elastic.py``) and the
device-pool arbiter that moves devices between a serving router and a
training gang (``arbiter.py``: :class:`DevicePoolArbiter`,
:class:`TrainerGang`)."""

from deeplearning4j_tpu_torch.resilience.arbiter import DevicePoolArbiter, TrainerGang  # noqa: F401
from deeplearning4j_tpu_torch.resilience.supervisor import (  # noqa: F401
    ClusterSupervisor, GangFailedError, GangIncident, SupervisedRun, supervise,
)

__all__ = ["ClusterSupervisor", "GangFailedError", "GangIncident", "SupervisedRun", "supervise",
           "DevicePoolArbiter", "TrainerGang"]
