"""Serving (port of ``deeplearning4j_tpu/serve``).

- :class:`InferenceEngine`: dynamic micro-batching over a captured
  forward on the model's device, buckets, a bounded queue with
  :class:`Overloaded` load shedding, per-request deadlines.
- :class:`ModelRegistry`: versioned deploy/hot-swap/rollback through the
  verified checkpoint path, ``deploy(..., precision="int8")`` through
  ``nn.quantize`` and the int8 dequant-matmul kernel.
- :class:`ModelServer`: stdlib HTTP JSON endpoint (``:predict``,
  ``:feedback``, ``/v1/models``, ``/healthz``, ``/metrics``).
- :class:`ReplicaRouter` + :class:`Autoscaler`: N replica engines of one
  model behind least-queue-depth dispatch, priority lanes, per-tenant
  quotas, queue-driven scaling and fan-out hot-swap.
- :class:`FeedbackLog`: the never-blocking feedback spool of the online
  loop (``online/``).
"""

from deeplearning4j_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from deeplearning4j_tpu_torch.serve.engine import (DeadlineExceeded, EngineClosed,
                                                   InferenceEngine, Overloaded)
from deeplearning4j_tpu_torch.serve.feedback import FeedbackLog
from deeplearning4j_tpu_torch.serve.registry import (ModelRegistry, ModelVersion,
                                                     RoutedModelError)
from deeplearning4j_tpu_torch.serve.router import (AdmissionControl, Lane, QuotaExceeded,
                                                   ReplicaRouter, TenantQuota)
from deeplearning4j_tpu_torch.serve.server import ModelServer

__all__ = [
    "AdmissionControl", "AutoscaleConfig", "Autoscaler",
    "DeadlineExceeded", "EngineClosed", "FeedbackLog", "InferenceEngine",
    "Lane", "ModelRegistry", "ModelServer", "ModelVersion", "Overloaded",
    "QuotaExceeded", "ReplicaRouter", "RoutedModelError", "TenantQuota",
]
