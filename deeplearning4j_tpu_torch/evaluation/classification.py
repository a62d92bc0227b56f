"""Classification evaluation (port of
``deeplearning4j_tpu/evaluation/classification.py``, numpy as there).

Parity with ND4J ``org/nd4j/evaluation/classification/Evaluation.java``
(confusion matrix, accuracy, precision/recall/F1 micro+macro, top-N,
Matthews correlation, G-measure, stats() report) and
``EvaluationBinary.java`` (per-output binary counts for multi-label).

Accumulation is host-side numpy over batches (``MultiLayerNetwork.evaluate``
reads each batch's output back from the device once); semantics follow the
reference: argmax over the class axis, masks zero out excluded rows
(time-series masking flattens [B,T,C] → [B*T, C] first).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _flatten_time(labels, predictions, mask):
    """[B,T,C] → [B*T,C] with mask rows dropped (reference semantics for
    time-series evaluation)."""
    if labels.ndim == 3:
        b, t, c = labels.shape
        labels = labels.reshape(b * t, c)
        predictions = predictions.reshape(b * t, c)
        if mask is not None:
            mask = np.asarray(mask).reshape(b * t)
    return labels, predictions, mask


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1,
                 labels: Optional[list[str]] = None):
        self.num_classes = num_classes
        self.top_n = top_n
        self.label_names = labels
        self.confusion: Optional[np.ndarray] = None  # [actual, predicted]
        self.top_n_correct = 0
        self.total = 0

    # ------------------------------------------------------------- accum
    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        labels, predictions, mask = _flatten_time(labels, predictions, mask)
        if (labels.ndim == 1 or labels.shape[-1] == 1) and predictions.shape[-1] <= 1:
            # single sigmoid output: binary at 0.5 threshold (Evaluation.java
            # single-output handling)
            actual = (labels.reshape(-1) >= 0.5).astype(np.int64)
            predicted = (predictions.reshape(-1) >= 0.5).astype(np.int64)
            n = 2
            predictions = np.stack([1.0 - predictions.reshape(-1),
                                    predictions.reshape(-1)], axis=-1)
        elif labels.ndim == 1 or labels.shape[-1] == 1:
            # integer class labels against multi-column predictions
            actual = labels.reshape(-1).astype(np.int64)
            n = int(predictions.shape[-1])
            predicted = np.argmax(predictions, axis=-1)
        else:
            actual = np.argmax(labels, axis=-1)
            n = labels.shape[-1]
            predicted = np.argmax(predictions, axis=-1)
        self._ensure(n)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            actual, predicted, predictions = actual[keep], predicted[keep], predictions[keep]
        np.add.at(self.confusion, (actual, predicted), 1)
        self.total += actual.shape[0]
        if self.top_n > 1:
            top = np.argsort(predictions, axis=-1)[:, -self.top_n:]
            self.top_n_correct += int(np.sum(top == actual[:, None]))
        else:
            self.top_n_correct += int(np.sum(predicted == actual))

    # ------------------------------------------------------------- metrics
    def _tp(self):  return np.diag(self.confusion).astype(np.float64)
    def _fp(self):  return self.confusion.sum(axis=0) - np.diag(self.confusion)
    def _fn(self):  return self.confusion.sum(axis=1) - np.diag(self.confusion)

    def accuracy(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trace(self.confusion) / self.total)

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.total if self.total else 0.0

    def precision(self, cls: Optional[int] = None, average: str = "macro") -> float:
        tp, fp = self._tp(), self._fp()
        if cls is not None:
            denom = tp[cls] + fp[cls]
            return float(tp[cls] / denom) if denom else 0.0
        if average == "micro":
            return float(tp.sum() / max(tp.sum() + fp.sum(), 1))
        with np.errstate(invalid="ignore", divide="ignore"):
            per = np.where(tp + fp > 0, tp / (tp + fp), np.nan)
        # reference excludes classes with no predictions from the macro avg
        return float(np.nanmean(per)) if not np.all(np.isnan(per)) else 0.0

    def recall(self, cls: Optional[int] = None, average: str = "macro") -> float:
        tp, fn = self._tp(), self._fn()
        if cls is not None:
            denom = tp[cls] + fn[cls]
            return float(tp[cls] / denom) if denom else 0.0
        if average == "micro":
            return float(tp.sum() / max(tp.sum() + fn.sum(), 1))
        with np.errstate(invalid="ignore", divide="ignore"):
            per = np.where(tp + fn > 0, tp / (tp + fn), np.nan)
        return float(np.nanmean(per)) if not np.all(np.isnan(per)) else 0.0

    def f1(self, cls: Optional[int] = None, average: str = "macro") -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if p + r else 0.0
        if average == "micro":
            p, r = self.precision(average="micro"), self.recall(average="micro")
            return 2 * p * r / (p + r) if p + r else 0.0
        scores = []
        for c in range(self.num_classes):
            tp, fp, fn = self._tp()[c], self._fp()[c], self._fn()[c]
            if tp + fp + fn == 0:
                continue
            p = tp / (tp + fp) if tp + fp else 0.0
            r = tp / (tp + fn) if tp + fn else 0.0
            scores.append(2 * p * r / (p + r) if p + r else 0.0)
        return float(np.mean(scores)) if scores else 0.0

    def gmeasure(self, cls: int) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return float(np.sqrt(p * r))

    def matthews_correlation(self, cls: int) -> float:
        tp = self._tp()[cls]
        fp = self._fp()[cls]
        fn = self._fn()[cls]
        tn = self.total - tp - fp - fn
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def false_positive_rate(self, cls: int) -> float:
        fp = self._fp()[cls]
        tn = self.total - self._tp()[cls] - fp - self._fn()[cls]
        return float(fp / (fp + tn)) if fp + tn else 0.0

    def false_negative_rate(self, cls: int) -> float:
        fn = self._fn()[cls]
        tp = self._tp()[cls]
        return float(fn / (fn + tp)) if fn + tp else 0.0

    def confusion_matrix(self) -> np.ndarray:
        return self.confusion.copy()

    def merge(self, other: "Evaluation") -> "Evaluation":
        """Distributed evaluation merge (``IEvaluation.merge`` — used by the
        Spark evaluation path; here by the data-parallel evaluator)."""
        if other.confusion is not None:
            self._ensure(other.num_classes)
            self.confusion += other.confusion
            self.total += other.total
            self.top_n_correct += other.top_n_correct
        return self

    # ------------------------------------------------------------- report
    def stats(self) -> str:
        names = self.label_names or [str(i) for i in range(self.num_classes or 0)]
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes:    {self.num_classes}",
                 f" Accuracy:        {self.accuracy():.4f}",
                 f" Precision:       {self.precision():.4f}",
                 f" Recall:          {self.recall():.4f}",
                 f" F1 Score:        {self.f1():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("")
        lines.append("=========================Confusion Matrix=========================")
        header = "      " + " ".join(f"{n:>6}" for n in names)
        lines.append(header)
        for i, row in enumerate(self.confusion):
            lines.append(f"{names[i]:>5} " + " ".join(f"{v:>6}" for v in row))
        lines.append("===================================================================")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()


class EvaluationBinary:
    """Per-output binary evaluation for multi-label sigmoid outputs
    (``EvaluationBinary.java``): independent TP/FP/TN/FN per output column
    at a 0.5 threshold (or custom)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        labels, predictions, mask = _flatten_time(labels, predictions, mask)
        pred = (predictions >= self.threshold).astype(np.int64)
        actual = (labels >= 0.5).astype(np.int64)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            pred, actual = pred[keep], actual[keep]
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64); self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64); self.fn = np.zeros(n, np.int64)
        self.tp += np.sum((pred == 1) & (actual == 1), axis=0)
        self.fp += np.sum((pred == 1) & (actual == 0), axis=0)
        self.tn += np.sum((pred == 0) & (actual == 0), axis=0)
        self.fn += np.sum((pred == 0) & (actual == 1), axis=0)

    def accuracy(self, output: Optional[int] = None) -> float:
        tp, fp, tn, fn = self.tp, self.fp, self.tn, self.fn
        if output is not None:
            tot = tp[output] + fp[output] + tn[output] + fn[output]
            return float((tp[output] + tn[output]) / tot) if tot else 0.0
        tot = (tp + fp + tn + fn).sum()
        return float((tp + tn).sum() / tot) if tot else 0.0

    def precision(self, output: int) -> float:
        d = self.tp[output] + self.fp[output]
        return float(self.tp[output] / d) if d else 0.0

    def recall(self, output: int) -> float:
        d = self.tp[output] + self.fn[output]
        return float(self.tp[output] / d) if d else 0.0

    def f1(self, output: int) -> float:
        p, r = self.precision(output), self.recall(output)
        return 2 * p * r / (p + r) if p + r else 0.0
