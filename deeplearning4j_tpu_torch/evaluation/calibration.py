"""Calibration evaluation (port of
``deeplearning4j_tpu/evaluation/calibration.py``, numpy as there).

Parity with ND4J ``org/nd4j/evaluation/classification/EvaluationCalibration.java``:
reliability diagram bins (mean predicted probability vs empirical accuracy
per bin), residual plot histogram, probability histograms, and expected
calibration error.
"""

from __future__ import annotations

import numpy as np


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._bin_counts = None        # [classes, bins]
        self._bin_correct = None
        self._bin_prob_sum = None
        self._residual_hist = None
        self._prob_hist = None

    def _ensure(self, n_classes: int):
        if self._bin_counts is None:
            shape = (n_classes, self.reliability_bins)
            self._bin_counts = np.zeros(shape, np.int64)
            self._bin_correct = np.zeros(shape, np.int64)
            self._bin_prob_sum = np.zeros(shape, np.float64)
            self._residual_hist = np.zeros(self.histogram_bins, np.int64)
            self._prob_hist = np.zeros((n_classes, self.histogram_bins), np.int64)

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                mask = np.asarray(mask).reshape(b * t)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        n_classes = labels.shape[-1]
        self._ensure(n_classes)
        bins = np.clip((predictions * self.reliability_bins).astype(np.int64),
                       0, self.reliability_bins - 1)
        is_label = labels >= 0.5
        for c in range(n_classes):
            np.add.at(self._bin_counts[c], bins[:, c], 1)
            np.add.at(self._bin_correct[c], bins[:, c], is_label[:, c].astype(np.int64))
            np.add.at(self._bin_prob_sum[c], bins[:, c], predictions[:, c])
            hbins = np.clip((predictions[:, c] * self.histogram_bins).astype(np.int64),
                            0, self.histogram_bins - 1)
            np.add.at(self._prob_hist[c], hbins, 1)
        residual = np.abs(labels - predictions).reshape(-1)
        rbins = np.clip((residual * self.histogram_bins).astype(np.int64),
                        0, self.histogram_bins - 1)
        np.add.at(self._residual_hist, rbins, 1)

    def reliability_diagram(self, cls: int):
        """Returns (mean_predicted_prob, fraction_positive) per bin."""
        counts = np.maximum(self._bin_counts[cls], 1)
        mean_prob = self._bin_prob_sum[cls] / counts
        frac_pos = self._bin_correct[cls] / counts
        return mean_prob, frac_pos

    def expected_calibration_error(self, cls: int) -> float:
        counts = self._bin_counts[cls]
        total = max(counts.sum(), 1)
        mean_prob, frac_pos = self.reliability_diagram(cls)
        return float(np.sum(counts / total * np.abs(mean_prob - frac_pos)))

    def residual_plot(self) -> np.ndarray:
        return self._residual_hist.copy()

    def probability_histogram(self, cls: int) -> np.ndarray:
        return self._prob_hist[cls].copy()
