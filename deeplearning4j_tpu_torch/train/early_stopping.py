"""Early stopping: an epoch-driven trainer with termination conditions
(port of ``deeplearning4j_tpu/train/early_stopping.py``, DL4J's
``org/deeplearning4j/earlystopping/`` package).

``EarlyStoppingConfiguration`` (a score calculator, epoch and iteration
termination conditions, a model saver), ``EarlyStoppingTrainer.fit()``
returning an ``EarlyStoppingResult`` (the reason, the score of each
evaluated epoch, the best model), the score calculators
(``DataSetLossCalculator``, ``ClassificationScoreCalculator``,
``RegressionScoreCalculator``), the epoch conditions
(``MaxEpochsTerminationCondition``,
``ScoreImprovementEpochTerminationCondition``), the iteration conditions
(``MaxTimeIterationTerminationCondition``,
``MaxScoreIterationTerminationCondition``,
``InvalidScoreIterationTerminationCondition``) and the savers
(``InMemoryModelSaver``, ``LocalFileModelSaver``).

Each epoch draws its random stream from a ``torch.Generator`` on the
net's device seeded ``conf.seed + 1000 + epoch``, as the JAX package
seeds its key; the two packages' streams differ, so their dropout masks
do too.  An iteration condition reads each step's loss on the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Optional, Sequence

import torch

# the per-epoch stream's seed is the config's seed plus this plus the epoch
EPOCH_SEED_OFFSET = 1000


# ------------------------------------------------------------------ scores
class ScoreCalculator:
    """The model-selection score after an epoch; ``minimize_score()`` says
    whether lower is better."""

    def calculate_score(self, net) -> float:
        raise NotImplementedError

    def minimize_score(self) -> bool:
        return True


class DataSetLossCalculator(ScoreCalculator):
    """The mean inference-mode loss over a held-out iterator, weighted by
    each batch's example count (``DataSetLossCalculator``)."""

    def __init__(self, iterator):
        self.iterator = iterator
        self._trainer = None    # one per net: it keeps the eval step

    def _trainer_for(self, net):
        from deeplearning4j_tpu_torch.train.trainer import Trainer
        if self._trainer is None or self._trainer.net is not net:
            self._trainer = Trainer(net)
        return self._trainer

    def calculate_score(self, net) -> float:
        trainer = self._trainer_for(net)
        total, count = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for batch in self.iterator:
            loss = trainer.eval_loss(batch)
            n = int(batch.features.shape[0]) if hasattr(batch, "features") else 1
            total += float(loss) * n
            count += n
        return total / max(count, 1)


class ClassificationScoreCalculator(ScoreCalculator):
    """An evaluation metric, maximized (``ClassificationScoreCalculator``):
    ``accuracy``, ``f1``, ``precision`` or ``recall``."""

    def __init__(self, iterator, metric: str = "accuracy"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, net) -> float:
        return float(getattr(net.evaluate(self.iterator), self.metric)())

    def minimize_score(self) -> bool:
        return False


class RegressionScoreCalculator(ScoreCalculator):
    """A regression metric, minimized (``RegressionScoreCalculator``):
    ``mse``, ``mae`` or ``rmse``."""

    _METRICS = {"mse": "average_mean_squared_error",
                "mae": "average_mean_absolute_error",
                "rmse": "root_mean_squared_error"}

    def __init__(self, iterator, metric: str = "mse"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, net) -> float:
        return float(getattr(net.evaluate_regression(self.iterator), self._METRICS[self.metric])())


# ------------------------------------------------------------- conditions
class EpochTerminationCondition:
    def initialize(self) -> None:
        """Reset at the start of ``fit`` (DL4J's ``initialize()``)."""

    def terminate(self, epoch: int, score: Optional[float], minimize: bool) -> bool:
        """``score`` is None on an epoch that was not evaluated
        (``evaluate_every_n_epochs`` > 1)."""
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, minimize) -> bool:
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop when the score has not improved by more than
    ``min_improvement`` for ``patience`` evaluated epochs in a row."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = patience
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._stale = 0

    def initialize(self) -> None:
        self._best = None
        self._stale = 0

    def terminate(self, epoch, score, minimize) -> bool:
        if score is None:       # not an evaluated epoch: no signal
            return False
        if self._best is None:
            self._best = score
            return False
        improved = self._best - score if minimize else score - self._best
        if improved > self.min_improvement:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return self._stale >= self.patience

    def __repr__(self):
        return (f"ScoreImprovementEpochTerminationCondition(patience={self.patience}, "
                f"min_improvement={self.min_improvement})")


class IterationTerminationCondition:
    def initialize(self) -> None:
        """Reset at the start of ``fit``."""

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start: Optional[float] = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score) -> bool:
        return (time.monotonic() - (self._start or time.monotonic())) > self.max_seconds

    def __repr__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop when the training loss exceeds a bound (a divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score) -> bool:
        return score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score) -> bool:
        return math.isnan(score) or math.isinf(score)

    def __repr__(self):
        return "InvalidScoreIterationTerminationCondition()"


# ----------------------------------------------------------------- savers
class InMemoryModelSaver:
    """Keeps the best (and optionally the latest) model in memory, as a
    ``clone()`` (a ``MultiLayerNetwork``)."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float) -> None:
        self._best = (net.clone(), score)

    def save_latest_model(self, net, score: float) -> None:
        self._latest = (net.clone(), score)

    def get_best_model(self):
        return self._best[0] if self._best else None

    def get_latest_model(self):
        return self._latest[0] if self._latest else None


class LocalFileModelSaver:
    """``bestModel.zip`` and ``latestModel.zip`` under a directory
    (``LocalFileModelSaver``), written by the durable checkpoint path
    (atomic, with a sha256 manifest) and verified on load: a damaged
    best model raises ``CheckpointCorruptError``.  A model loads back as
    the type it was saved as, on the device it was saved from."""

    def __init__(self, directory: str):
        self.directory = directory
        self._device = None
        os.makedirs(directory, exist_ok=True)

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latestModel.zip")

    def save_best_model(self, net, score: float) -> None:
        self._device = net.device
        net.save(self.best_path)

    def save_latest_model(self, net, score: float) -> None:
        self._device = net.device
        net.save(self.latest_path)

    def _load_verified(self, path: str):
        from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE
        from deeplearning4j_tpu_torch.io.model_serializer import restore_model
        if not os.path.exists(path):
            return None
        return restore_model(path, device=self._device or DEFAULT_DEVICE)

    def get_best_model(self):
        return self._load_verified(self.best_path)

    def get_latest_model(self):
        return self._load_verified(self.latest_path)


# ------------------------------------------------------------ config/result
@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator
    epoch_termination_conditions: Sequence[EpochTerminationCondition] = ()
    iteration_termination_conditions: Sequence[IterationTerminationCondition] = ()
    model_saver: Any = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str     # "EpochTerminationCondition" | "IterationTerminationCondition"
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingTrainer:
    """Epoch-wise training with early stopping (``EarlyStoppingTrainer.fit``):
    each batch through ``Trainer.step_batch`` (its listeners, counters and
    tBPTT routing), the iteration conditions after each step, the score
    and the best model after each evaluated epoch, then the epoch
    conditions."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator,
                 listeners=None):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator
        self.listeners = listeners

    def fit(self) -> EarlyStoppingResult:
        from deeplearning4j_tpu_torch.train.trainer import Trainer
        cfg = self.config
        if not cfg.epoch_termination_conditions and not cfg.iteration_termination_conditions:
            raise ValueError(
                "EarlyStoppingConfiguration needs at least one termination condition (e.g. "
                "MaxEpochsTerminationCondition or MaxTimeIterationTerminationCondition), or "
                "fit() would never return")
        minimize = cfg.score_calculator.minimize_score()
        best_score = math.inf if minimize else -math.inf
        best_epoch = -1
        scores: dict[int, float] = {}
        trainer = Trainer(self.net, listeners=self.listeners)
        for cond in (*cfg.iteration_termination_conditions, *cfg.epoch_termination_conditions):
            cond.initialize()
        epoch = 0
        reason, details = "EpochTerminationCondition", ""
        while True:
            stop_iter = None
            stream = torch.Generator(device=self.net.device).manual_seed(
                self.net.conf.seed + EPOCH_SEED_OFFSET + epoch)
            if hasattr(self.train_iterator, "reset"):
                self.train_iterator.reset()
            for batch in self.train_iterator:
                loss = trainer.step_batch(batch, stream)
                if cfg.iteration_termination_conditions:
                    loss = float(loss)
                    stop_iter = next((c for c in cfg.iteration_termination_conditions
                                      if c.terminate(loss)), None)
                    if stop_iter is not None:
                        break
            if stop_iter is not None:
                reason, details = "IterationTerminationCondition", repr(stop_iter)
                break
            epoch_score: Optional[float] = None
            if epoch % cfg.evaluate_every_n_epochs == 0:
                epoch_score = float(cfg.score_calculator.calculate_score(self.net))
                scores[epoch] = epoch_score
                if epoch_score < best_score if minimize else epoch_score > best_score:
                    best_score, best_epoch = epoch_score, epoch
                    cfg.model_saver.save_best_model(self.net, epoch_score)
            if cfg.save_last_model:
                cfg.model_saver.save_latest_model(self.net, epoch_score)
            # score None on an epoch that was not evaluated
            stop_epoch = next((c for c in cfg.epoch_termination_conditions
                               if c.terminate(epoch, epoch_score, minimize)), None)
            self.net.epoch += 1
            if stop_epoch is not None:
                details = repr(stop_epoch)
                break
            epoch += 1
        best_model = cfg.model_saver.get_best_model()
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details, score_vs_epoch=scores,
            best_model_epoch=best_epoch, best_model_score=best_score, total_epochs=epoch + 1,
            best_model=best_model if best_model is not None else self.net)
