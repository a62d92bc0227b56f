"""Training listener bus (port of ``deeplearning4j_tpu/obs/listeners.py``).

DL4J's ``TrainingListener`` callbacks (``ScoreIterationListener``,
``PerformanceListener``, ``TimeIterationListener``,
``EvaluativeListener``, ``CollectScoresIterationListener``): a trainer
calls :meth:`ListenerBus.dispatch` with a hook's name, and every
listener that has the hook runs it.

A listener that reads the clock (``PerformanceListener``,
``TimeIterationListener``) first waits for the model's CUDA device
(``train.capture.device_synchronize``: ``torch.cuda.synchronize``, after
any capture another thread runs), so that the time it reads covers the work
queued on the card and not only its launch.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional

import torch

log = logging.getLogger("deeplearning4j_tpu_torch")


def synchronized_time(model: Any) -> float:
    """``time.perf_counter()`` after the model's CUDA device (its
    ``device`` attribute) has finished its queued work; no wait for a
    model on the CPU or without a device."""
    device = getattr(model, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        from deeplearning4j_tpu_torch.train.capture import device_synchronize
        device_synchronize(device)
    return time.perf_counter()


class TrainingListener:
    """Callback interface.  All hooks are optional; ``model`` is the
    network object, ``info`` a plain dict of host-side scalars."""

    def on_epoch_start(self, model: Any, epoch: int) -> None: ...

    def on_epoch_end(self, model: Any, epoch: int, info: dict) -> None: ...

    def on_forward_pass(self, model: Any, activations: Any) -> None: ...

    def on_gradient_calculation(self, model: Any, gradients: Any) -> None: ...

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None: ...

    def on_fit_start(self, model: Any) -> None: ...

    def on_fit_end(self, model: Any, info: dict) -> None: ...


class ListenerBus:
    def __init__(self, listeners: Optional[list[TrainingListener]] = None):
        self.listeners: list[TrainingListener] = list(listeners or [])

    def add(self, listener: TrainingListener) -> None:
        self.listeners.append(listener)

    def dispatch(self, hook: str, *args: Any, **kwargs: Any) -> None:
        for listener in self.listeners:
            fn = getattr(listener, hook, None)
            if fn is not None:
                fn(*args, **kwargs)


class ScoreIterationListener(TrainingListener):
    """Logs the score (loss) every N iterations."""

    def __init__(self, frequency: int = 10):
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            log.info("Score at iteration %d (epoch %d) is %.6f", iteration, epoch, score)


class CollectScoresListener(TrainingListener):
    """Accumulates (iteration, score) pairs in memory."""

    def __init__(self):
        self.iterations: list[int] = []
        self.scores: list[float] = []

    def iteration_done(self, model, iteration, epoch, score):
        self.iterations.append(iteration)
        self.scores.append(float(score))


class PerformanceListener(TrainingListener):
    """Samples/sec and batches/sec every N iterations, timed on the
    host's clock after a synchronize of the model's device."""

    def __init__(self, frequency: int = 10, report_batch: bool = True):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self._last_time: float | None = None
        self._last_iter = 0
        self._samples_since = 0

    def record_batch(self, batch_size: int) -> None:
        self._samples_since += batch_size

    def iteration_done(self, model, iteration, epoch, score):
        now = synchronized_time(model)
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            msg = f"{iters / dt:.1f} batches/sec"
            if self._samples_since:
                msg += f", {self._samples_since / dt:.1f} samples/sec"
            log.info("Perf at iteration %d: %s", iteration, msg)
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0


class TimeIterationListener(TrainingListener):
    """Estimates the remaining training time."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score):
        if iteration and iteration % self.frequency == 0:
            elapsed = synchronized_time(model) - self._start
            per_iter = elapsed / max(iteration, 1)
            remaining = per_iter * max(self.total - iteration, 0)
            log.info("Iteration %d/%d, ETA %.1fs", iteration, self.total, remaining)


class EvaluativeListener(TrainingListener):
    """Runs an evaluation every N iterations (``invocation="iteration"``)
    or at each epoch's end (``"epoch_end"``)."""

    def __init__(self, iterator_factory: Callable[[], Any], frequency: int = 0,
                 invocation: str = "epoch_end"):
        self.iterator_factory = iterator_factory
        self.frequency = frequency
        self.invocation = invocation
        self.evaluations: list[Any] = []

    def _evaluate(self, model) -> None:
        evaluation = model.evaluate(self.iterator_factory())
        self.evaluations.append(evaluation)
        log.info("EvaluativeListener: accuracy=%.4f", evaluation.accuracy())

    def iteration_done(self, model, iteration, epoch, score):
        if self.invocation == "iteration" and self.frequency and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, model, epoch, info):
        if self.invocation == "epoch_end":
            self._evaluate(model)
