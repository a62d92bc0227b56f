"""Structured jsonl metrics (port of ``deeplearning4j_tpu/obs/metrics.py``).

DL4J streams per-iteration statistics through ``StatsListener`` →
``StatsStorage`` → its web UI; here the same records go to an
append-only jsonl file that any notebook or dashboard can read, in the
JAX package's format.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from deeplearning4j_tpu_torch.obs.listeners import TrainingListener
from deeplearning4j_tpu_torch.obs.registry import get_registry


class MetricsWriter:
    """Append-only jsonl writer; one file per run.  Every record also
    ticks ``tpudl_obs_records_total`` in the unified registry so the
    ``/metrics`` endpoint reflects stream liveness."""

    def __init__(self, path: str):
        self.path = path
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    def write(self, record: dict[str, Any]) -> None:
        record = {"ts": time.time(), **record}
        self._fh.write(json.dumps(record, default=_to_jsonable) + "\n")
        get_registry().counter("tpudl_obs_records_total").inc()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _to_jsonable(obj: Any) -> Any:
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


class StatsListener(TrainingListener):
    """StatsListener parity: writes the score (and, with ``with_norms``,
    the gradient norms of the last ``on_gradient_calculation``) every
    ``frequency`` iterations, and each epoch's end, to jsonl.  Neither
    package's ``Trainer`` dispatches ``on_gradient_calculation`` (the JAX
    package only declares the hook), so through ``fit`` a record carries
    the score alone; a caller that dispatches the hook gets the norms."""

    def __init__(self, writer: MetricsWriter, frequency: int = 1,
                 with_norms: bool = False):
        self.writer = writer
        self.frequency = max(1, frequency)
        self.with_norms = with_norms
        self._norms: Optional[dict] = None

    def on_gradient_calculation(self, model, gradients):
        if self.with_norms:
            import torch
            from deeplearning4j_tpu_torch.utils.pytree import param_table
            table = param_table(gradients)
            # one copy to the host for every norm, not a read per leaf
            norms = torch.stack([torch.linalg.vector_norm(v.float()) for v in table.values()])
            self._norms = dict(zip(table, norms.tolist()))

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            return
        record = {"event": "iteration", "iteration": iteration, "epoch": epoch, "score": float(score)}
        if self._norms:
            record["grad_norms"] = self._norms
            self._norms = None
        self.writer.write(record)

    def on_epoch_end(self, model, epoch, info):
        self.writer.write({"event": "epoch_end", "epoch": epoch, **info})
