"""ROC / AUC evaluation (port of ``deeplearning4j_tpu/evaluation/roc.py``,
numpy as there).

Parity with ND4J ``org/nd4j/evaluation/classification/ROC.java``
(exact mode: every distinct score is a threshold; thresholded mode:
``thresholdSteps`` uniform bins), ``ROCBinary`` (per-output) and
``ROCMultiClass`` (one-vs-all per class).  AUROC via trapezoidal rule on
the exact curve (reference semantics), AUPRC likewise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ROC:
    """Binary ROC.  ``threshold_steps=0`` → exact mode (stores all scores,
    like the reference); >0 → fixed-bin histogram mode."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._scores: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []
        self._pos_hist = None
        self._neg_hist = None

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            # two-column softmax output: positive class = column 1
            labels = labels[..., 1]
            predictions = predictions[..., 1]
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        if self.threshold_steps:
            bins = np.clip((predictions * self.threshold_steps).astype(np.int64),
                           0, self.threshold_steps - 1)
            if self._pos_hist is None:
                self._pos_hist = np.zeros(self.threshold_steps, np.int64)
                self._neg_hist = np.zeros(self.threshold_steps, np.int64)
            np.add.at(self._pos_hist, bins[labels >= 0.5], 1)
            np.add.at(self._neg_hist, bins[labels < 0.5], 1)
        else:
            self._scores.append(predictions.astype(np.float64))
            self._labels.append(labels.astype(np.float64))

    def _curve(self):
        """Returns (fpr, tpr, precision, recall) arrays over thresholds."""
        if self.threshold_steps:
            pos = self._pos_hist[::-1].cumsum()  # predicted-positive above threshold
            neg = self._neg_hist[::-1].cumsum()
            total_pos = self._pos_hist.sum()
            total_neg = self._neg_hist.sum()
            tpr = pos / max(total_pos, 1)
            fpr = neg / max(total_neg, 1)
            with np.errstate(invalid="ignore"):
                prec = np.where(pos + neg > 0, pos / np.maximum(pos + neg, 1), 1.0)
            rec = tpr
            return fpr, tpr, prec, rec
        scores = np.concatenate(self._scores) if self._scores else np.zeros(0)
        labels = np.concatenate(self._labels) if self._labels else np.zeros(0)
        order = np.argsort(-scores, kind="stable")
        labels = labels[order]
        tps = np.cumsum(labels >= 0.5)
        fps = np.cumsum(labels < 0.5)
        total_pos = max(tps[-1] if len(tps) else 0, 1)
        total_neg = max(fps[-1] if len(fps) else 0, 1)
        tpr = np.concatenate([[0.0], tps / total_pos])
        fpr = np.concatenate([[0.0], fps / total_neg])
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = np.concatenate([[1.0], tps / np.maximum(tps + fps, 1)])
        rec = tpr
        return fpr, tpr, prec, rec

    def calculate_auc(self) -> float:
        fpr, tpr, _, _ = self._curve()
        return float(np.trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        _, _, prec, rec = self._curve()
        return float(np.trapezoid(prec, rec))

    def merge(self, other: "ROC") -> "ROC":
        if self.threshold_steps:
            if other._pos_hist is not None:
                if self._pos_hist is None:
                    self._pos_hist = other._pos_hist.copy()
                    self._neg_hist = other._neg_hist.copy()
                else:
                    self._pos_hist += other._pos_hist
                    self._neg_hist += other._neg_hist
        else:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)
        return self


class ROCBinary:
    """Per-output-column ROC for multi-label binary outputs
    (``ROCBinary.java``)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self.rocs: Optional[list[ROC]] = None

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        if self.rocs is None:
            self.rocs = [ROC(self.threshold_steps) for _ in range(labels.shape[-1])]
        for i, roc in enumerate(self.rocs):
            roc.eval(labels[..., i], predictions[..., i], mask)

    def calculate_auc(self, output: int = 0) -> float:
        return self.rocs[output].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs]))


class ROCMultiClass(ROCBinary):
    """One-vs-all ROC per class for softmax outputs (``ROCMultiClass.java``).
    Column i's score is P(class=i); label is 1 for rows of class i."""

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                mask = np.asarray(mask).reshape(b * t)
        super().eval(labels, predictions, mask)
