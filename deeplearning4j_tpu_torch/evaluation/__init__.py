"""Evaluation of a net's outputs on the host, in numpy (port of
``deeplearning4j_tpu/evaluation``)."""

from deeplearning4j_tpu_torch.evaluation.classification import Evaluation, EvaluationBinary
from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.evaluation.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_tpu_torch.evaluation.calibration import EvaluationCalibration

__all__ = [
    "Evaluation", "EvaluationBinary", "RegressionEvaluation",
    "ROC", "ROCBinary", "ROCMultiClass", "EvaluationCalibration",
]
