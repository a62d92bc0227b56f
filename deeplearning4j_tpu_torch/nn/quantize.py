"""Post-training quantization (port of ``deeplearning4j_tpu/nn/quantize.py``).

Converts a net's dense, embedding and conv weights to
**per-output-channel int8** (symmetric, scale = amax/127 per channel)
while activations stay in the policy's compute dtype.  A quantized
``DenseLayer`` (hence ``OutputLayer``) runs its product through the int8
dequant-matmul (:mod:`deeplearning4j_tpu_torch.ops.kernels.quant_matmul`);
a quantized ``EmbeddingLayer`` (hence ``EmbeddingSequenceLayer``)
gathers int8 rows and scales them; a quantized ``ConvolutionLayer``
widens its kernel on read.  The quantized net is the
same ``MultiLayerNetwork`` class with the same configuration: its param
dicts carry ``W_q``/``W_scale`` in place of ``W``.

**Calibration** (:func:`calibrate`) runs holdout batches through the
full-precision and the quantized forwards and records the observed
output deviation; the :class:`QuantizationReport` carries the calibrated
``tolerance_band`` that the quantized net is held to.  The deploy gate
that scores a quantized candidate is ``online.gate.GatedDeployer``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_QUANT_EPS = 1e-12


@dataclasses.dataclass
class QuantizationReport:
    """What one :func:`quantize_net` pass did."""

    layers_quantized: int
    fp_weight_bytes: int           # bytes the quantized tensors occupied
    quantized_weight_bytes: int    # int8 payload + f32 scales
    max_abs_err: Optional[float] = None    # calibration: max |q - fp|
    mean_abs_err: Optional[float] = None
    tolerance_band: Optional[float] = None  # calibrated parity band
    calibration_batches: int = 0

    @property
    def compression_ratio(self) -> float:
        return self.fp_weight_bytes / max(self.quantized_weight_bytes, 1)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["compression_ratio"] = round(self.compression_ratio, 3)
        return d


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a weight whose
    LAST axis is the output-channel axis.  Returns ``(w_q int8,
    scale f32[n_out])`` with ``w ≈ w_q * scale``; a bf16 weight is widened
    to f32 first."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=tuple(range(w32.ndim - 1)))
    scale = torch.clamp_min(amax, _QUANT_EPS) / 127.0
    w_q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return w_q, scale


def dequantize_weight(w_q, scale, dtype=torch.float32) -> torch.Tensor:
    """``w_q * scale`` in f32, cast to ``dtype``: the conv path's
    widen-on-read (the int8 operand is widened inside the product, with
    no f32 copy of its own)."""
    return (w_q * scale.to(torch.float32)).to(dtype)


def _quantizable(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.conv import ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, EmbeddingLayer
    return isinstance(layer, (DenseLayer, EmbeddingLayer, ConvolutionLayer))


def quantize_net(net, calibration=None, safety_factor: float = 2.0):
    """Post-training-quantize a ``MultiLayerNetwork``: per-channel int8
    weights for every dense, embedding and conv layer, biases untouched, activations
    on the policy's compute dtype.

    Returns a NEW net (a deep copy; ``net`` keeps serving) with
    ``quantized_ == "int8"`` and ``quantization_`` holding the
    :class:`QuantizationReport`.  ``calibration``, an optional iterable of
    batches (feature arrays or tensors, or objects with ``features``),
    runs through both forwards, and ``safety_factor`` times the largest
    deviation becomes the report's ``tolerance_band``."""
    layers = getattr(net, "layers", None)
    params = getattr(net, "params_", None)
    if layers is None or not isinstance(params, list):
        raise TypeError(
            f"quantize_net supports MultiLayerNetwork-family nets "
            f"(per-layer param list); got {type(net).__name__}")
    qnet = net.clone()
    n_quantized = fp_bytes = q_bytes = 0
    for i, layer in enumerate(qnet.layers):
        layer_params = qnet.params_[i]
        w = layer_params.get("W") if isinstance(layer_params, dict) else None
        if w is None or not _quantizable(layer) or w.ndim < 2:
            continue
        w_q, scale = quantize_weight(w)
        new_params = {k: v for k, v in layer_params.items() if k != "W"}
        new_params["W_q"] = w_q
        new_params["W_scale"] = scale
        qnet.params_[i] = new_params
        n_quantized += 1
        fp_bytes += w.numel() * w.element_size()
        q_bytes += w.numel() + 4 * int(scale.shape[0])
    report = QuantizationReport(n_quantized, fp_bytes, q_bytes)
    if calibration is not None and n_quantized:
        _calibrate(net, qnet, calibration, report, safety_factor)
    qnet.quantized_ = "int8"
    qnet.quantization_ = report
    return qnet


def _features(batch):
    return batch.features if hasattr(batch, "features") else batch


def _numpy(y) -> np.ndarray:
    return y.float().cpu().numpy() if torch.is_tensor(y) else np.asarray(y, np.float32)


def _calibrate(net, qnet, calibration, report: QuantizationReport,
               safety_factor: float) -> None:
    """Holdout pass: the quantized forward's deviation from the
    full-precision forward."""
    if hasattr(calibration, "reset"):
        calibration.reset()
    max_err = sum_err = 0.0
    count = batches = 0
    for batch in calibration:
        x = _features(batch)
        err = np.abs(_numpy(qnet.output(x)) - _numpy(net.output(x)))
        max_err = max(max_err, float(err.max(initial=0.0)))
        sum_err += float(err.sum())
        count += err.size
        batches += 1
    if batches:
        report.max_abs_err = max_err
        report.mean_abs_err = sum_err / max(count, 1)
        report.tolerance_band = float(safety_factor * max_err)
        report.calibration_batches = batches


def calibrate(net, holdout, safety_factor: float = 2.0) -> QuantizationReport:
    """Quantize a copy of ``net`` and measure its deviation band over
    ``holdout`` without serving anything."""
    return quantize_net(net, calibration=holdout,
                        safety_factor=safety_factor).quantization_
