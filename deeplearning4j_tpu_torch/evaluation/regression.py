"""Regression evaluation (port of
``deeplearning4j_tpu/evaluation/regression.py``, numpy as there).

Parity with ND4J ``org/nd4j/evaluation/regression/RegressionEvaluation.java``:
per-column MSE, MAE, RMSE, RSE (relative squared error), PC (Pearson
correlation), R² — streamed over batches with mask support.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, column_names: Optional[list[str]] = None):
        self.column_names = column_names
        self.n = None
        # streaming sums per column
        self._count = None
        self._sum_err2 = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label2 = None
        self._sum_pred = None
        self._sum_pred2 = None
        self._sum_label_pred = None

    def _ensure(self, n):
        if self.n is None:
            self.n = n
            z = lambda: np.zeros(n, np.float64)
            self._count = z(); self._sum_err2 = z(); self._sum_abs_err = z()
            self._sum_label = z(); self._sum_label2 = z()
            self._sum_pred = z(); self._sum_pred2 = z(); self._sum_label_pred = z()

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                mask = np.asarray(mask).reshape(b * t)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        self._ensure(labels.shape[-1])
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        err = labels - predictions
        self._count += labels.shape[0]
        self._sum_err2 += np.sum(err * err, axis=0)
        self._sum_abs_err += np.sum(np.abs(err), axis=0)
        self._sum_label += np.sum(labels, axis=0)
        self._sum_label2 += np.sum(labels * labels, axis=0)
        self._sum_pred += np.sum(predictions, axis=0)
        self._sum_pred2 += np.sum(predictions * predictions, axis=0)
        self._sum_label_pred += np.sum(labels * predictions, axis=0)

    # ---------------------------------------------------------- metrics
    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_err2[col] / max(self._count[col], 1))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs_err[col] / max(self._count[col], 1))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int = 0) -> float:
        n = self._count[col]
        mean_label = self._sum_label[col] / n
        ss_tot = self._sum_label2[col] - n * mean_label ** 2
        return float(self._sum_err2[col] / ss_tot) if ss_tot else float("inf")

    def pearson_correlation(self, col: int = 0) -> float:
        n = self._count[col]
        cov = self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col] / n
        var_l = self._sum_label2[col] - self._sum_label[col] ** 2 / n
        var_p = self._sum_pred2[col] - self._sum_pred[col] ** 2 / n
        denom = np.sqrt(var_l * var_p)
        return float(cov / denom) if denom else 0.0

    def r_squared(self, col: int = 0) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_err2 / np.maximum(self._count, 1)))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self._sum_abs_err / np.maximum(self._count, 1)))

    def merge(self, other: "RegressionEvaluation") -> "RegressionEvaluation":
        if other.n is not None:
            self._ensure(other.n)
            for attr in ("_count", "_sum_err2", "_sum_abs_err", "_sum_label",
                         "_sum_label2", "_sum_pred", "_sum_pred2", "_sum_label_pred"):
                setattr(self, attr, getattr(self, attr) + getattr(other, attr))
        return self

    def stats(self) -> str:
        names = self.column_names or [f"col{i}" for i in range(self.n or 0)]
        lines = [f"{'column':<10}{'MSE':>12}{'MAE':>12}{'RMSE':>12}{'RSE':>12}{'PC':>12}{'R^2':>12}"]
        for i, name in enumerate(names):
            lines.append(
                f"{name:<10}{self.mean_squared_error(i):>12.5f}"
                f"{self.mean_absolute_error(i):>12.5f}"
                f"{self.root_mean_squared_error(i):>12.5f}"
                f"{self.relative_squared_error(i):>12.5f}"
                f"{self.pearson_correlation(i):>12.5f}"
                f"{self.r_squared(i):>12.5f}")
        return "\n".join(lines)
