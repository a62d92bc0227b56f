"""Observability: the training listener bus (``listeners.py``), the
metrics registry (``registry.py``), span tracing (``tracing.py``), the
flight recorder (``flight_recorder.py``), the health monitor
(``health.py``), jsonl metrics (``metrics.py``), profiling hooks
(``profiler.py``), the per-layer statistics pipeline (``stats.py``), the
cluster telemetry federation (``remote.py``) and the dashboard server
that is its coordinator (``ui_server.py``)."""

from deeplearning4j_tpu_torch.obs.listeners import (
    CollectScoresListener, EvaluativeListener, ListenerBus, PerformanceListener,
    ScoreIterationListener, TimeIterationListener, TrainingListener,
)
from deeplearning4j_tpu_torch.obs import remote
from deeplearning4j_tpu_torch.obs.metrics import MetricsWriter
from deeplearning4j_tpu_torch.obs.profiler import StepTimer, check_finite
from deeplearning4j_tpu_torch.obs.remote import ClusterStore, RemoteStatsRouter
from deeplearning4j_tpu_torch.obs.stats import (
    FileStatsStorage, InMemoryStatsStorage, StatsListener, render_html, render_html_report,
)

from deeplearning4j_tpu_torch.obs.ui_server import UIServer

__all__ = ["TrainingListener", "ListenerBus", "ScoreIterationListener", "CollectScoresListener",
           "PerformanceListener", "TimeIterationListener", "EvaluativeListener",
           "MetricsWriter", "check_finite", "StepTimer", "StatsListener",
           "InMemoryStatsStorage", "FileStatsStorage", "render_html_report", "render_html",
           "remote", "ClusterStore", "RemoteStatsRouter", "UIServer"]
