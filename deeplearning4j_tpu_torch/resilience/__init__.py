"""Fault tolerance: durable checkpoint files (``checkpoint.py``),
deterministic fault injection (``faults.py``), the retry policy
(``retry.py``), self-healing gangs (``supervisor.py``:
:class:`ClusterSupervisor` detects a worker's death or stall, tears the
gang down, respawns it from the newest verified checkpoint under a
per-slot restart budget, and shrinks or halts past it) and the elastic
resize state machine the supervisor drives (``elastic.py``).  The JAX
package's device-pool arbiter is not ported yet."""

from deeplearning4j_tpu_torch.resilience.supervisor import (  # noqa: F401
    ClusterSupervisor, GangFailedError, GangIncident, SupervisedRun, supervise,
)

__all__ = ["ClusterSupervisor", "GangFailedError", "GangIncident", "SupervisedRun", "supervise"]
