"""Observability: the training listener bus (``obs/listeners.py``)."""

from deeplearning4j_tpu_torch.obs.listeners import (
    CollectScoresListener, EvaluativeListener, ListenerBus, PerformanceListener,
    ScoreIterationListener, TimeIterationListener, TrainingListener,
)

__all__ = ["TrainingListener", "ListenerBus", "ScoreIterationListener", "CollectScoresListener",
           "PerformanceListener", "TimeIterationListener", "EvaluativeListener"]
