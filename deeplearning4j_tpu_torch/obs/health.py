"""Training health monitor (port of ``deeplearning4j_tpu/obs/health.py``).

:class:`HealthMonitor` is a :class:`~deeplearning4j_tpu_torch.obs.listeners.TrainingListener`
that streams verdicts over the scalars the trainer already hands its
listeners (the loss each iteration) and, through :meth:`stats_ready`,
over per-layer statistics dicts in the JAX package's layout.  The port's
trainer computes no step statistics yet, so on it the loss checks run and
the gradient/update checks run only where a caller feeds them.

Checks (each verdict increments ``tpudl_health_anomalies_total{kind}``):

- ``non_finite_loss``: NaN/Inf loss, caught the same iteration;
- ``loss_spike``: robust z-score (median/MAD over a rolling window)
  beyond ``spike_zscore``;
- ``grad_explosion`` / ``grad_vanish``: total gradient L2 norm outside
  ``[grad_norm_min, grad_norm_max]``;
- ``non_finite_grad``: NaN/Inf in any layer's gradient stats;
- ``update_ratio``: log10(update:param mean-magnitude ratio) outside
  ``update_ratio_band``;
- ``dead_units``: fraction of near-zero gradient entries above
  ``dead_fraction_max``;
- ``straggler``: a worker's median step time beyond ``factor``x its
  peers' median (:func:`stragglers`).

Actions per anomaly (``actions=`` tuple, applied in order):

- ``"warn"``: log + metrics only;
- ``"dump"``: fire the flight recorder; the dump header's ``reason`` is
  ``health:<kind>``;
- ``"checkpoint"``: checkpoint now through
  :class:`~deeplearning4j_tpu_torch.io.checkpoint.CheckpointListener`
  (``save_now``), so the last pre-anomaly state is durable;
- ``"halt"``: raise :class:`HealthHalt` out of the training loop.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import statistics
import time
from typing import Any, Callable, Optional

from deeplearning4j_tpu_torch.obs.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_tpu_torch")

# MAD → stdev for a normal distribution
_MAD_SCALE = 1.4826


class HealthHalt(RuntimeError):
    """Raised by the ``halt`` action: training stopped on an anomaly."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"training halted by HealthMonitor ({kind}): "
                         f"{message}")
        self.kind = kind


def robust_zscore(window, value: float) -> Optional[float]:
    """|value - median| / (1.4826 * MAD) over ``window`` — robust to the
    outliers it exists to find.  None when the window is degenerate
    (too small, or MAD == 0 with value == median)."""
    vals = list(window)
    if len(vals) < 3:
        return None
    med = statistics.median(vals)
    mad = statistics.median(abs(v - med) for v in vals)
    scale = _MAD_SCALE * mad
    if scale <= 0:
        # a flat window: any deviation at all is infinitely surprising —
        # report a large finite score so thresholds still compare
        return None if value == med else math.inf
    return abs(value - med) / scale


def stragglers(medians: dict, factor: float = 2.0,
               min_excess_s: float = 0.02) -> list:
    """Workers whose median step time exceeds ``factor`` x the median of
    their PEERS' medians (leave-one-out, so a straggler's own inflated
    time can't mask itself in a small gang) AND sits at least
    ``min_excess_s`` above it — on millisecond-scale steps a loaded host
    scheduler can double an innocent worker's median, and a relative
    check alone would page on that jitter.  ``medians``: worker →
    median step seconds (None entries ignored).  Needs >= 2 reporting
    workers."""
    valid = {w: float(m) for w, m in medians.items() if m}
    if len(valid) < 2:
        return []
    out = []
    for worker, m in valid.items():
        peer_med = statistics.median(v for w, v in valid.items()
                                     if w != worker)
        if (peer_med > 0 and m > factor * peer_med
                and m - peer_med > min_excess_s):
            out.append(worker)
    return sorted(out)


def report_anomaly(kind: str, message: str, **facts: Any) -> None:
    """Shared verdict sink (monitor-local and cluster checks): metrics +
    flight-recorder ring event + warning log."""
    from deeplearning4j_tpu_torch.obs import flight_recorder
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    reg = get_registry()
    reg.labeled_counter("tpudl_health_anomalies_total",
                        label_names=("kind",)).inc(kind=kind)
    facts.pop("kind", None)   # the ring event's own kind is "health"
    flight_recorder.record("health", anomaly=kind, message=message, **facts)
    log.warning("health: %s anomaly: %s", kind, message)


@dataclasses.dataclass
class HealthConfig:
    """Thresholds for :class:`HealthMonitor`.  Defaults are deliberately
    loose — a monitor that cries wolf gets turned off."""

    window: int = 64                 # rolling loss window
    min_samples: int = 8             # spike check warmup
    spike_zscore: float = 10.0       # robust z beyond this = spike
    grad_norm_max: float = 1e4       # total grad L2 above = explosion
    grad_norm_min: float = 1e-8      # total grad L2 below = vanished
    update_ratio_band: tuple = (-7.0, -0.5)   # log10(update:param) band
    dead_fraction_max: float = 0.95  # near-zero grad fraction above = dead
    straggler_factor: float = 2.0    # cluster check (stragglers)


class HealthMonitor(TrainingListener):
    """Streaming health judge over the trainer's existing telemetry.

    The loss check runs every iteration (the loss scalar the listeners
    already receive, one device pull).  The gradient/update checks run
    on the statistics handed to :meth:`stats_ready`, every ``frequency``
    iterations.

    ``actions`` run in order on every anomaly; ``on_anomaly`` (if given)
    is called with the anomaly dict after the built-in actions (hook for
    custom responses).  ``checkpoint_listener`` is required for the
    ``checkpoint`` action; ``dump_path`` overrides the flight-recorder
    dump target for ``dump``.
    """

    wants_model_stats = True

    def __init__(self, config: Optional[HealthConfig] = None,
                 frequency: int = 10,
                 actions: tuple = ("warn",),
                 checkpoint_listener=None,
                 dump_path: Optional[str] = None,
                 on_anomaly: Optional[Callable[[dict], None]] = None):
        self.config = config or HealthConfig()
        self.frequency = max(1, int(frequency))
        self.actions = tuple(actions)
        unknown = set(self.actions) - {"warn", "dump", "checkpoint", "halt"}
        if unknown:
            raise ValueError(f"unknown health actions {sorted(unknown)}")
        if "checkpoint" in self.actions and checkpoint_listener is None:
            raise ValueError("the 'checkpoint' action needs a "
                             "checkpoint_listener (io.checkpoint."
                             "CheckpointListener)")
        self.checkpoint_listener = checkpoint_listener
        self.dump_path = dump_path
        self.on_anomaly = on_anomaly
        self.anomalies: list[dict] = []
        self._losses: list[float] = []
        self._last_checked = -1

    # ----------------------------------------------------- stats sampling
    def wants_stats_now(self, iteration: int) -> bool:
        return iteration % self.frequency == 0

    # ------------------------------------------------------------ verdicts
    def _anomaly(self, kind: str, message: str, model=None,
                 iteration: Optional[int] = None, epoch: int = 0,
                 **facts: Any) -> None:
        from deeplearning4j_tpu_torch.obs import flight_recorder
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        record = {"kind": kind, "message": message, "iteration": iteration,
                  "time": time.time(), **facts}
        self.anomalies.append(record)
        report_anomaly(kind, message, iteration=iteration, **facts)
        reg = get_registry()
        actions = reg.labeled_counter("tpudl_health_actions_total",
                                      label_names=("action",))
        for action in self.actions:
            actions.inc(action=action)
            if action == "dump":
                # the black box, fired by a SEMANTIC anomaly: the header
                # names the anomaly so triage starts from the reason line
                flight_recorder.dump(self.dump_path,
                                     reason=f"health:{kind}",
                                     detail=dict(record))
            elif action == "checkpoint" and model is not None:
                try:
                    self.checkpoint_listener.save_now(
                        model, iteration=iteration, epoch=epoch)
                except Exception as e:
                    log.warning("health: checkpoint-now failed: %r", e)
            elif action == "halt":
                if self.on_anomaly is not None:
                    self.on_anomaly(record)
                raise HealthHalt(kind, message)
        if self.on_anomaly is not None:
            self.on_anomaly(record)

    # --------------------------------------------------------- loss stream
    def iteration_done(self, model, iteration, epoch, score):
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        if iteration == self._last_checked:
            return
        self._last_checked = iteration
        cfg = self.config
        reg = get_registry()
        reg.counter("tpudl_health_checks_total").inc()
        loss = float(score)          # the one scalar pull
        if not math.isfinite(loss):
            self._anomaly("non_finite_loss",
                          f"loss is {loss!r} at iteration {iteration}",
                          model=model, iteration=iteration, epoch=epoch)
            return                   # a NaN would poison the window
        z = robust_zscore(self._losses[-cfg.window:], loss) \
            if len(self._losses) >= cfg.min_samples else None
        if z is not None and math.isfinite(z):
            reg.gauge("tpudl_health_loss_zscore").set(z)
        if z is not None and z > cfg.spike_zscore:
            self._anomaly("loss_spike",
                          f"loss {loss:.6g} is {z if math.isfinite(z) else 'inf'}"
                          f" robust sigmas from the rolling median",
                          model=model, iteration=iteration, epoch=epoch,
                          zscore=(z if math.isfinite(z) else None),
                          loss=loss)
        self._losses.append(loss)
        if len(self._losses) > cfg.window:
            del self._losses[:-cfg.window]

    # --------------------------------------------------------- stats stream
    def stats_ready(self, model, iteration, epoch, score, stats):
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        get_registry().counter("tpudl_health_checks_total").inc()
        cfg = self.config
        grads = stats.get("gradients", {}) or {}
        norms, dead = [], []
        for layer, st in grads.items():
            norm = st.get("norm")
            if norm is None or not math.isfinite(float(norm)):
                self._anomaly("non_finite_grad",
                              f"layer {layer} gradient stats are "
                              f"non-finite at iteration {iteration}",
                              model=model, iteration=iteration, epoch=epoch,
                              layer=str(layer))
                return
            norms.append(float(norm))
            zf = st.get("zero_fraction")
            if zf is not None:
                dead.append((layer, float(zf)))
        if norms:
            total = math.sqrt(sum(n * n for n in norms))
            if total > cfg.grad_norm_max:
                self._anomaly("grad_explosion",
                              f"total gradient norm {total:.4g} > "
                              f"{cfg.grad_norm_max:g} at iteration "
                              f"{iteration}", model=model,
                              iteration=iteration, epoch=epoch,
                              grad_norm=total)
            elif total < cfg.grad_norm_min:
                self._anomaly("grad_vanish",
                              f"total gradient norm {total:.4g} < "
                              f"{cfg.grad_norm_min:g} at iteration "
                              f"{iteration}", model=model,
                              iteration=iteration, epoch=epoch,
                              grad_norm=total)
        for layer, frac in dead:
            if frac > cfg.dead_fraction_max:
                self._anomaly("dead_units",
                              f"layer {layer}: {frac:.1%} of gradient "
                              f"entries are ~zero at iteration "
                              f"{iteration}", model=model,
                              iteration=iteration, epoch=epoch,
                              layer=str(layer), dead_fraction=frac)
        lo, hi = cfg.update_ratio_band
        params = stats.get("params", {}) or {}
        updates = stats.get("updates", {}) or {}
        for layer in updates:
            p = params.get(layer)
            u = updates.get(layer)
            if not p or not u:
                continue
            pm, um = p.get("mean_magnitude"), u.get("mean_magnitude")
            if not pm or not um or pm <= 0 or um <= 0:
                continue
            ratio = math.log10(um / pm)
            if ratio < lo or ratio > hi:
                self._anomaly("update_ratio",
                              f"layer {layer}: log10(update:param) = "
                              f"{ratio:.2f} outside [{lo}, {hi}] at "
                              f"iteration {iteration}", model=model,
                              iteration=iteration, epoch=epoch,
                              layer=str(layer), log10_ratio=ratio)
