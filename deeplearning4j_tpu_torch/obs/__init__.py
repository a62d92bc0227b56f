"""Observability: the training listener bus (``listeners.py``), the
metrics registry (``registry.py``), span tracing (``tracing.py``), the
flight recorder (``flight_recorder.py``) and the health monitor
(``health.py``)."""

from deeplearning4j_tpu_torch.obs.listeners import (
    CollectScoresListener, EvaluativeListener, ListenerBus, PerformanceListener,
    ScoreIterationListener, TimeIterationListener, TrainingListener,
)

__all__ = ["TrainingListener", "ListenerBus", "ScoreIterationListener", "CollectScoresListener",
           "PerformanceListener", "TimeIterationListener", "EvaluativeListener"]
