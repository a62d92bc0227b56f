"""``ParallelInference``: a thin shim over the serving engine (port of
``deeplearning4j_tpu/parallel/inference.py``).

The parity surface of DL4J's ``ParallelInference``: callers submit single
inputs from many threads, and a worker batches them through one forward
and scatters the results back.  The batching lives in
:class:`~deeplearning4j_tpu_torch.serve.engine.InferenceEngine`
(deadline-bounded flushes, buckets, a bounded queue, the
``tpudl_serve_*`` metrics); the engine serves on the model's device.
By default a submit against a full queue blocks the submitting thread;
with ``shed=True`` it fails at once with
:class:`~deeplearning4j_tpu_torch.serve.engine.Overloaded`.
"""

from __future__ import annotations

from concurrent.futures import Future

import numpy as np

from deeplearning4j_tpu_torch.serve.engine import InferenceEngine, Overloaded

__all__ = ["ParallelInference", "Overloaded"]


class ParallelInference:
    def __init__(self, model, batch_limit: int = 32, queue_limit: int = 64,
                 timeout_ms: float = 5.0, shed: bool = False):
        """``model``: anything the engine serves (a ``MultiLayerNetwork`` or
        ``ComputationGraph``), called with [B, ...] batches."""
        self.model = model
        self.batch_limit = batch_limit
        self.queue_limit = queue_limit
        self.timeout_s = timeout_ms / 1000.0
        self.shed = shed
        self._engine = InferenceEngine(model, name="parallel_inference", max_batch=batch_limit,
                                       max_latency_ms=timeout_ms, queue_limit=queue_limit)

    @property
    def engine(self) -> InferenceEngine:
        """The underlying engine (metrics, buckets, shutdown)."""
        return self._engine

    def output(self, x) -> np.ndarray:
        """Blocking inference of one example (or a small batch)."""
        return np.asarray(self.output_async(x).result())

    def output_async(self, x) -> Future:
        return self._engine.submit(np.asarray(x), block=not self.shed)

    def shutdown(self):
        self._engine.shutdown(drain=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
