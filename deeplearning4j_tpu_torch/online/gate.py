"""Eval gate + post-deploy watch: the only sanctioned door to deploy
(port of ``deeplearning4j_tpu/online/gate.py``).

A continual-learning loop that hot-swaps every candidate it trains is a
production outage generator: one bad feedback batch, one NaN'd
fine-tune, one torn candidate zip, and the serving fleet regresses.
The gate makes deployment an *earned* transition:

1. **verify** — the candidate zip is loaded through the resilience
   layer's verified path; a corrupt file raises
   ``CheckpointCorruptError`` and is refused before anything is scored,
   let alone swapped.
2. **score** — candidate vs. incumbent on a held-out slice, using the
   ``evaluation/`` metrics (classification accuracy/F1 or eval loss).
   A non-finite candidate score is an automatic refusal.
3. **decide** — deploy only on non-regression
   (``candidate >= incumbent - min_delta`` for higher-is-better
   metrics); the registry's verified hot-swap does the flip with zero
   dropped in-flight requests.
4. **watch** — :class:`DeployWatch` samples the live
   ``tpudl_serve_*``/``tpudl_health_*`` series for a window after the
   flip; an error-rate, p99, or health-verdict regression rolls the
   swap back automatically.

Every decision increments the ``tpudl_online_*`` counters and leaves a
flight-recorder ring event, so a refused candidate is triaged from the
black box, not from a shrug (docs/online.md has the runbook).

Nets are loaded onto the registry's device, so candidate and incumbent
are scored where they would serve.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.obs import flight_recorder
from deeplearning4j_tpu_torch.obs.registry import get_registry

HIGHER_IS_BETTER = {"accuracy": True, "f1": True, "loss": False}


@dataclasses.dataclass
class GateDecision:
    """One gate verdict, serializable into bench records and ring
    events."""

    deploy: bool
    reason: str
    metric: str
    candidate_score: float
    incumbent_score: float
    delta: float
    gate_seconds: float = 0.0
    version: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _finite(value: float) -> bool:
    return isinstance(value, (int, float)) and math.isfinite(float(value))


class EvalGate:
    """Scores nets on a held-out slice.

    ``holdout`` is any DataSetIterator; ``metric`` one of ``accuracy``,
    ``f1`` (macro), ``loss`` (eval loss via the net's loss function).
    ``min_delta`` is the regression tolerance: a candidate within
    ``min_delta`` of the incumbent still deploys (non-regression, not
    strict improvement — continual data shift makes exact ties common).
    """

    def __init__(self, holdout, metric: str = "accuracy",
                 min_delta: float = 0.0,
                 higher_is_better: Optional[bool] = None):
        if higher_is_better is None:
            if metric not in HIGHER_IS_BETTER:
                raise ValueError(
                    f"unknown gate metric {metric!r}; pass "
                    f"higher_is_better= for custom metrics")
            higher_is_better = HIGHER_IS_BETTER[metric]
        self.holdout = holdout
        self.metric = metric
        self.min_delta = float(min_delta)
        self.higher_is_better = bool(higher_is_better)

    # -------------------------------------------------------------- scoring
    def score(self, net) -> float:
        if self.metric == "loss":
            return self._eval_loss(net)
        evaluation = net.evaluate(self.holdout)
        if self.metric == "f1":
            return float(evaluation.f1())
        return float(evaluation.accuracy())

    def _eval_loss(self, net) -> float:
        from deeplearning4j_tpu_torch.train.trainer import Trainer
        trainer = Trainer(net)
        losses, weights = [], []
        for batch in self.holdout:
            losses.append(float(trainer.eval_loss(batch)))
            weights.append(batch.features.shape[0])
        if not losses:
            return float("nan")
        return float(np.average(losses, weights=weights))

    def improves(self, candidate_score: float,
                 incumbent_score: float) -> bool:
        """Non-regression test, direction-aware."""
        if not _finite(candidate_score):
            return False
        if not _finite(incumbent_score):
            return True          # nothing sane to regress against
        if self.higher_is_better:
            return candidate_score >= incumbent_score - self.min_delta
        return candidate_score <= incumbent_score + self.min_delta


class GatedDeployer:
    """The eval-gated deploy path: verify → score → compare → hot-swap.

    The ONLY place the online loop touches ``ModelRegistry.deploy``.  A
    refusal leaves the incumbent serving untouched.
    """

    def __init__(self, registry, gate: EvalGate):
        self.registry = registry
        self.gate = gate
        # the incumbent only changes on deploy/rollback (a new version
        # number), and its zip is immutable — cache its holdout score
        # per (name, version) so a stream of refused candidates doesn't
        # re-load and re-evaluate the same incumbent every round
        self._incumbent_scores: dict[str, tuple[int, float]] = {}

    @staticmethod
    def _as_served(net, precision: Optional[str], calibration=None):
        """Quantize ``net`` exactly the way ``registry.deploy`` will, so
        the gate scores what would actually serve — scoring the
        full-precision candidate and then deploying an int8 variant
        would let quantization error sneak past the gate."""
        if precision != "int8":
            return net
        from deeplearning4j_tpu_torch.nn import quantize
        return quantize.quantize_net(net, calibration=calibration)

    def _device(self):
        """Where the registry loads (its engines' device)."""
        return getattr(self.registry, "device", "cuda")

    def _incumbent_score(self, entry) -> float:
        from deeplearning4j_tpu_torch.io.model_serializer import restore_model
        cached = self._incumbent_scores.get(entry.name)
        if cached is not None and cached[0] == entry.version:
            return cached[1]
        incumbent = restore_model(entry.path, load_updater=False,
                                  device=self._device())
        incumbent = self._as_served(incumbent,
                                    getattr(entry, "precision", None))
        score = self.gate.score(incumbent)
        self._incumbent_scores[entry.name] = (entry.version, score)
        return score

    def deploy_if_better(self, name: str, candidate_path: str,
                         precision: Optional[str] = None,
                         calibration=None,
                         prebake_artifacts: bool = False,
                         **engine_kw) -> GateDecision:
        """Verify → score → compare → hot-swap.  ``precision="int8"``
        gates a QUANTIZED candidate: the candidate is quantized before
        scoring (the same transform the deploy applies), so the
        non-regression decision covers the quantization error too — a
        quantization that costs accuracy vs the serving incumbent is
        refused here and the incumbent keeps serving.

        ``prebake_artifacts=True`` asks the deploy to bake compiled
        programs into the zip, which needs the compiled-artifact store
        (not ported yet): the deploy then raises and the candidate is
        refused with that reason."""
        from deeplearning4j_tpu_torch.io.model_serializer import restore_model
        from deeplearning4j_tpu_torch.resilience.checkpoint import \
            CheckpointCorruptError
        reg = get_registry()
        reg.counter("tpudl_online_candidates_total").inc()
        t0 = time.perf_counter()
        incumbent_score = float("nan")
        try:
            entry = self.registry.get(name)
        except KeyError:
            entry = None
        try:
            # verified load — a torn/bit-rotted candidate is refused
            # HERE, before scoring, long before any pointer flips
            candidate = restore_model(candidate_path, load_updater=False,
                                      device=self._device())
            candidate = self._as_served(candidate, precision,
                                        calibration=calibration)
            candidate_score = self.gate.score(candidate)
            if entry is not None:
                incumbent_score = self._incumbent_score(entry)
        except CheckpointCorruptError as e:
            return self._refuse(name, f"candidate failed verification: {e}",
                                float("nan"), incumbent_score, t0)
        except Exception as e:
            return self._refuse(name, f"gate scoring failed: "
                                      f"{type(e).__name__}: {e}",
                                float("nan"), incumbent_score, t0)
        delta = (candidate_score - incumbent_score
                 if _finite(candidate_score) and _finite(incumbent_score)
                 else float("nan"))
        if not _finite(candidate_score):
            return self._refuse(name, "candidate gate score is non-finite",
                                candidate_score, incumbent_score, t0)
        if not self.gate.improves(candidate_score, incumbent_score):
            return self._refuse(
                name, f"gate regression: candidate {self.gate.metric}="
                      f"{candidate_score:.6g} vs incumbent "
                      f"{incumbent_score:.6g} (min_delta="
                      f"{self.gate.min_delta:g})",
                candidate_score, incumbent_score, t0)
        try:
            # A router-managed name fans the verified swap across the
            # WHOLE replica set atomically: one verified load, every
            # replica flipped, each old engine drained.
            router = self.registry.router_for(name)
            if router is not None:
                entry = router.deploy(candidate_path,
                                      precision=precision,
                                      calibration=calibration,
                                      bake_artifacts=prebake_artifacts,
                                      **engine_kw)
            else:
                entry = self.registry.deploy(
                    name, candidate_path, precision=precision,
                    calibration=calibration,
                    bake_artifacts=prebake_artifacts, **engine_kw)
        except Exception as e:
            # deploy re-verifies the zip; a failure here never touched
            # the serving pointer — the incumbent keeps serving
            return self._refuse(name, f"deploy refused: "
                                      f"{type(e).__name__}: {e}",
                                candidate_score, incumbent_score, t0)
        gate_s = time.perf_counter() - t0
        decision = GateDecision(True, "non-regression", self.gate.metric,
                                candidate_score, incumbent_score,
                                delta if _finite(delta) else 0.0,
                                gate_seconds=gate_s, version=entry.version)
        reg.counter("tpudl_online_deploys_total").inc()
        if _finite(delta):
            reg.gauge("tpudl_online_gate_delta").set(delta)
        reg.histogram("tpudl_online_gate_seconds").observe(gate_s)
        flight_recorder.record("online_gate", model=name, deploy=True,
                               version=entry.version,
                               candidate=round(candidate_score, 6),
                               incumbent=(round(incumbent_score, 6)
                                          if _finite(incumbent_score)
                                          else None))
        return decision

    def _refuse(self, name: str, reason: str, candidate_score: float,
                incumbent_score: float, t0: float) -> GateDecision:
        reg = get_registry()
        gate_s = time.perf_counter() - t0
        delta = (candidate_score - incumbent_score
                 if _finite(candidate_score) and _finite(incumbent_score)
                 else float("nan"))
        reg.counter("tpudl_online_refusals_total").inc()
        if _finite(delta):
            reg.gauge("tpudl_online_gate_delta").set(delta)
        reg.histogram("tpudl_online_gate_seconds").observe(gate_s)
        flight_recorder.record("online_gate", model=name, deploy=False,
                               reason=reason[:300])
        return GateDecision(False, reason, self.gate.metric,
                            candidate_score, incumbent_score,
                            delta if _finite(delta) else 0.0,
                            gate_seconds=gate_s)


def _p99_from_buckets(before: dict, after: dict) -> Optional[float]:
    """p99 upper-bound estimate from the delta of two cumulative-bucket
    snapshots of the serve latency histogram (Prometheus semantics:
    smallest upper bound whose cumulative delta covers 99%)."""
    deltas = {ub: after.get(ub, 0) - before.get(ub, 0) for ub in after}
    total = max(deltas.values() or [0])
    if total <= 0:
        return None
    target = 0.99 * total
    for ub in sorted(deltas):
        if deltas[ub] >= target:
            return None if math.isinf(ub) else float(ub)
    return None


class DeployWatch:
    """Post-deploy regression watch over the LIVE serve telemetry.

    Snapshots the serve counters/histogram and the health-anomaly
    counter at deploy time, then polls for ``window_s``; the first
    regression — error-rate above ``error_rate_max``, estimated p99
    above ``p99_max_s``, or any new health verdict — rolls the swap
    back through the registry's verified path and counts
    ``tpudl_online_rollbacks_total``.  Returns a verdict dict either
    way (``rolled_back``, ``reason``, ``mttr_s``: detection→restored).
    On a router-managed model ``registry.rollback`` delegates to the
    router, so the regression response rolls EVERY replica back
    together — the watch stays router-agnostic.

    With ``slo_monitor`` (anything with ``evaluate_once()``,
    ``breach_count()`` and ``breaches()``, as the JAX package's
    ``obs.slo.SLOMonitor``; that module is not ported yet), any NEW SLO breach inside the watch window is a
    regression too: a post-deploy error-budget burn rides the same
    rollback path as a raw error-rate spike, so the budget policy and
    the deploy gate can never disagree.  The watch drives the monitor
    itself (``evaluate_once`` per poll) so a short watch window never
    races the monitor's own cadence.
    """

    def __init__(self, registry, name: str, window_s: float = 10.0,
                 poll_s: float = 0.25,
                 error_rate_max: float = 0.25,
                 p99_max_s: Optional[float] = None,
                 min_requests: int = 4,
                 health_verdicts_max: int = 0,
                 slo_monitor=None):
        self.registry = registry
        self.name = name
        self.window_s = float(window_s)
        self.poll_s = max(0.01, float(poll_s))
        self.error_rate_max = float(error_rate_max)
        self.p99_max_s = p99_max_s
        self.min_requests = max(1, int(min_requests))
        self.health_verdicts_max = max(0, int(health_verdicts_max))
        self.slo_monitor = slo_monitor

    def _snapshot(self) -> dict:
        reg = get_registry()
        requests = reg.labeled_counter("tpudl_serve_requests_total")
        return {
            "ok": requests.labeled_value(status="ok"),
            "error": requests.labeled_value(status="error"),
            "expired": requests.labeled_value(status="expired"),
            "latency": reg.histogram(
                "tpudl_serve_latency_seconds").bucket_counts(),
            "health": reg.labeled_counter(
                "tpudl_health_anomalies_total",
                label_names=("kind",)).value,
            "slo_breaches": (self.slo_monitor.breach_count()
                            if self.slo_monitor is not None else 0),
        }

    def _regression(self, before: dict) -> Optional[str]:
        if self.slo_monitor is not None:
            self.slo_monitor.evaluate_once()
        now = self._snapshot()
        breach_delta = now["slo_breaches"] - before["slo_breaches"]
        if breach_delta > 0:
            names = sorted({b.slo for b in
                            self.slo_monitor.breaches()
                            [-int(breach_delta):]})
            return (f"{int(breach_delta)} new SLO breach(es) in the "
                    f"watch window ({', '.join(names)})")
        bad = (now["error"] - before["error"]) \
            + (now["expired"] - before["expired"])
        ok = now["ok"] - before["ok"]
        total = ok + bad
        if total >= self.min_requests \
                and bad / total > self.error_rate_max:
            return (f"serve error rate {bad / total:.0%} over "
                    f"{int(total)} requests (max "
                    f"{self.error_rate_max:.0%})")
        health_delta = now["health"] - before["health"]
        if health_delta > self.health_verdicts_max:
            return (f"{int(health_delta)} new health verdicts in the "
                    f"watch window")
        if self.p99_max_s is not None:
            p99 = _p99_from_buckets(before["latency"], now["latency"])
            if p99 is not None and p99 > self.p99_max_s:
                return (f"serve p99 ~{p99:g}s above {self.p99_max_s:g}s")
        return None

    def run(self) -> dict:
        reg = get_registry()
        before = self._snapshot()
        deadline = time.monotonic() + self.window_s
        while time.monotonic() < deadline:
            reason = self._regression(before)
            if reason is not None:
                detected = time.perf_counter()
                flight_recorder.record("online_rollback", model=self.name,
                                       reason=reason[:300])
                restored = self.registry.rollback(self.name)
                mttr = time.perf_counter() - detected
                reg.counter("tpudl_online_rollbacks_total").inc()
                return {"rolled_back": True, "reason": reason,
                        "mttr_s": mttr,
                        "restored_version": restored.version}
            time.sleep(self.poll_s)
        return {"rolled_back": False, "reason": "window clean",
                "mttr_s": 0.0, "restored_version": None}
