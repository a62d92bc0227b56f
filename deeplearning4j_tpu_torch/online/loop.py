"""OnlineTrainer: the background continual-learning loop (port of
``deeplearning4j_tpu/online/loop.py``).

One loop iteration (a **round**) is the whole closed loop end to end:

1. **trigger** — enough unassigned feedback records
   (``min_records``) or enough wall time (``interval_s``) since the
   last round;
2. **resume** — fine-tune from the latest VERIFIED checkpoint: the
   lineage directory's newest intact zip
   (:meth:`~deeplearning4j_tpu_torch.io.checkpoint.CheckpointListener.
   last_checkpoint_in`), or — when a previous attempt at THIS round was
   killed mid-fit — the round's own mid-fit checkpoints, fast-forwarded
   through ``Trainer.fit(resume_from=...)`` so the resumed round
   consumes exactly the records the uninterrupted one would have
   (the resilience layer's 1e-6 contract over feedback data);
3. **fine-tune** — with a
   :class:`~deeplearning4j_tpu_torch.obs.health.HealthMonitor` attached:
   anomalous candidates (NaN'd loss, exploding gradients) are ABORTED,
   counted, and never reach the gate;
4. **gate + deploy** — :class:`~deeplearning4j_tpu_torch.online.gate.
   GatedDeployer` scores candidate vs. incumbent on the held-out slice
   and hot-swaps only on non-regression (verified registry path);
5. **watch** — an optional
   :class:`~deeplearning4j_tpu_torch.online.gate.DeployWatch` window rolls a
   freshly deployed version back when live serve metrics regress;
6. **promote** — only a deployed-and-watch-clean candidate becomes the
   new lineage head.  Refused, aborted, and rolled-back rounds leave
   the lineage untouched: the next round re-trains from the incumbent
   on newer data.

Supervision: the loop thread carries its own restart budget
(``max_consecutive_failures``, with exponential backoff between
attempts); each round stamps ``online.loop`` progress into the flight
recorder, so a wedged loop trips the watchdog and leaves a black box.
Its round/lineage state is all on disk, so a restarted loop resumes
exactly.  Nets load onto the registry's device: the fine-tune trains
where the registry serves.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.obs import flight_recorder
from deeplearning4j_tpu_torch.obs.health import HealthConfig, HealthHalt, HealthMonitor
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.online.gate import DeployWatch, GateDecision, GatedDeployer
from deeplearning4j_tpu_torch.online.source import FeedbackSource
from deeplearning4j_tpu_torch.resilience.checkpoint import atomic_write

log = logging.getLogger("deeplearning4j_tpu_torch")

LINEAGE_DIRNAME = "lineage"
STATE_NAME = "online_state.json"


@dataclasses.dataclass
class OnlineConfig:
    """Knobs for :class:`OnlineTrainer` (docs/online.md has the table)."""

    interval_s: float = 30.0            # round trigger: time since last
    min_records: int = 32               # ... or this many new records
    max_records_per_round: int = 512    # window cap per round
    batch_size: int = 16
    epochs_per_round: int = 1           # passes over the round window
    sampling: str = "fifo"              # fifo | reservoir | recency
    seed: int = 0
    weighted: bool = False              # feedback weights as labels_mask
    checkpoint_every_n_iterations: int = 25   # mid-round durability
    watch_window_s: float = 0.0         # post-deploy watch (0 = off)
    watch_poll_s: float = 0.25
    watch_error_rate_max: float = 0.25
    watch_p99_max_s: Optional[float] = None
    max_consecutive_failures: int = 3   # loop supervision budget
    poll_s: float = 0.5                 # trigger-check cadence
    # pre-bake a gate-passing candidate's compiled programs into its
    # zip: needs the compiled-artifact store, which is not ported yet,
    # so it is off (True makes every deploy refuse, naming that)
    prebake_artifacts: bool = False


class OnlineTrainer:
    """Closed-loop continual learning for ONE deployed model name.

    ``workdir`` owns all loop state (round stamps live with the spool;
    lineage + per-round checkpoints + the round counter live here), so
    a killed loop process restarted on the same directories resumes
    exactly.  ``base_path`` seeds the lineage before the first deploy-
    worthy candidate exists (usually the zip the incumbent was deployed
    from)."""

    def __init__(self, registry, name: str, spool_dir: str, workdir: str,
                 gate, base_path: str,
                 config: Optional[OnlineConfig] = None,
                 health_config: Optional[HealthConfig] = None,
                 health_actions: tuple = ("halt",),
                 listeners: Optional[list] = None,
                 engine_kw: Optional[dict] = None):
        self.registry = registry
        self.name = name
        self.spool_dir = spool_dir
        self.workdir = workdir
        self.base_path = base_path
        self.config = config or OnlineConfig()
        self.health_config = health_config
        self.health_actions = tuple(health_actions)
        self.listeners = list(listeners or [])
        self.engine_kw = dict(engine_kw or {})
        self.deployer = GatedDeployer(registry, gate)
        os.makedirs(self.workdir, exist_ok=True)
        os.makedirs(self._lineage_dir(), exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # written by start() (caller thread) AND _finish_round (loop
        # thread): a stop()-then-start() overlapping a timed-out join
        # leaves the OLD loop thread racing the new start's write
        self._round_t_lock = threading.Lock()
        self._last_round_t = 0.0
        self.failed: Optional[str] = None     # set when the budget burns

    # ------------------------------------------------------------ loop state
    def _lineage_dir(self) -> str:
        return os.path.join(self.workdir, LINEAGE_DIRNAME)

    def _round_dir(self, r: int) -> str:
        return os.path.join(self.workdir, f"round-{r}")

    def _state_path(self) -> str:
        return os.path.join(self.workdir, STATE_NAME)

    def next_round(self) -> int:
        import json
        try:
            with open(self._state_path(), encoding="utf-8") as f:
                return int(json.load(f).get("next_round", 0))
        except (OSError, ValueError):
            return 0

    def _advance_round(self, r: int) -> None:
        import json
        with atomic_write(self._state_path()) as tmp:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"next_round": r + 1, "updated": time.time()}, f)

    def _source(self) -> FeedbackSource:
        cfg = self.config
        return FeedbackSource(self.spool_dir, batch_size=cfg.batch_size,
                              max_records_per_round=cfg.max_records_per_round,
                              sampling=cfg.sampling, seed=cfg.seed,
                              model=self.name, weighted=cfg.weighted)

    def lineage_head(self) -> str:
        """Newest verified checkpoint to fine-tune from: the lineage
        directory's newest intact zip, else the base model."""
        from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
        head = CheckpointListener.last_checkpoint_in(self._lineage_dir())
        return head or self.base_path

    # -------------------------------------------------------------- one round
    def run_once(self, force: bool = False) -> dict:
        """Run (or resume) the next round end to end; returns a decision
        record.  ``force`` skips the min-records trigger (tests, the
        example, bench)."""
        import json

        from deeplearning4j_tpu_torch.data.iterators import ResumableIterator
        from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
        from deeplearning4j_tpu_torch.io.model_serializer import (read_training_state,
                                                                  restore_model, write_model)
        from deeplearning4j_tpu_torch.train.trainer import Trainer

        cfg = self.config
        reg = get_registry()
        source = self._source()
        r = self.next_round()
        round_dir = self._round_dir(r)
        flight_recorder.progress("online.loop", round=r)
        reg.gauge("tpudl_online_spool_depth").set(source.pending())
        reg.gauge("tpudl_online_staleness_seconds").set(source.staleness_s())

        manifest_path = os.path.join(round_dir, "round.json")
        resuming = os.path.exists(manifest_path)
        if not resuming and not force and source.pending() < cfg.min_records:
            return {"round": r, "status": "skipped",
                    "reason": f"only {source.pending()} unassigned records "
                              f"(min_records={cfg.min_records})"}

        # round manifest: pins WHAT this round fine-tunes from and the
        # run-total epoch target, so a killed round restarts identically
        if resuming:
            with open(manifest_path, encoding="utf-8") as f:
                manifest = json.load(f)
        else:
            head = self.lineage_head()
            state = read_training_state(head) or {}
            manifest = {"round": r, "resume_from": head,
                        "target_epochs": int(state.get("epoch", 0))
                        + cfg.epochs_per_round}
            os.makedirs(round_dir, exist_ok=True)
            with atomic_write(manifest_path) as tmp:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(manifest, f)

        # mid-round checkpoints (from a killed attempt) win over the
        # lineage head: that is what makes the resumed fit exact
        resume_from = CheckpointListener.last_checkpoint_in(round_dir) \
            or manifest["resume_from"]

        source.pin_round(r)
        decision: dict = {"round": r, "window": source.stamp_round(r)}
        resumable = ResumableIterator(source)
        net = restore_model(resume_from, load_updater=False,
                            device=getattr(self.registry, "device", "cuda"))
        ckpt_listener = CheckpointListener(
            round_dir,
            save_every_n_iterations=cfg.checkpoint_every_n_iterations,
            keep_last=2, iterator=resumable)
        monitor = HealthMonitor(config=self.health_config,
                                actions=self.health_actions,
                                frequency=max(1, cfg.checkpoint_every_n_iterations))
        trainer = Trainer(net, listeners=[ckpt_listener, monitor,
                                          *self.listeners])
        t_round0 = time.perf_counter()
        try:
            trainer.fit(resumable, epochs=int(manifest["target_epochs"]),
                        resume_from=resume_from)
        except HealthHalt as halt:
            reg.counter("tpudl_online_candidates_total").inc()
            reg.counter("tpudl_online_candidates_aborted_total").inc()
            flight_recorder.record("online_round", round=r, status="aborted",
                                   anomaly=halt.kind)
            self._finish_round(r, source, reg)
            decision.update({"status": "aborted", "anomaly": halt.kind,
                             "reason": str(halt)})
            return decision
        finally:
            ckpt_listener.close()

        fine_tune_s = time.perf_counter() - t_round0
        candidate_path = os.path.join(round_dir, "candidate.zip")
        write_model(net, candidate_path)
        gate_decision: GateDecision = self.deployer.deploy_if_better(
            self.name, candidate_path,
            prebake_artifacts=cfg.prebake_artifacts, **self.engine_kw)
        decision.update({"status": "deployed" if gate_decision.deploy
                         else "refused",
                         "gate": gate_decision.to_dict(),
                         "fine_tune_s": fine_tune_s})
        # router-managed serving: the gate fanned the swap across the
        # whole replica set — record how wide the deploy landed
        router = self.registry.router_for(self.name) \
            if hasattr(self.registry, "router_for") else None
        if router is not None and gate_decision.deploy:
            decision["replicas"] = router.replicas
        if gate_decision.deploy and cfg.watch_window_s > 0:
            watch = DeployWatch(
                self.registry, self.name, window_s=cfg.watch_window_s,
                poll_s=cfg.watch_poll_s,
                error_rate_max=cfg.watch_error_rate_max,
                p99_max_s=cfg.watch_p99_max_s)
            verdict = watch.run()
            decision["watch"] = verdict
            if verdict["rolled_back"]:
                decision["status"] = "rolled_back"
        if decision["status"] == "deployed":
            # promotion is LAST: only a deployed, watch-clean candidate
            # becomes the state future rounds fine-tune from
            lineage_path = os.path.join(
                self._lineage_dir(),
                f"checkpoint_iter{net.iteration}_epoch{net.epoch}.zip")
            write_model(net, lineage_path)
        self._finish_round(r, source, reg)
        flight_recorder.record("online_round", round=r,
                               status=decision["status"],
                               gate=decision.get("gate", {}).get("reason"))
        return decision

    def _finish_round(self, r: int, source: FeedbackSource, reg) -> None:
        self._advance_round(r)
        with self._round_t_lock:
            self._last_round_t = time.monotonic()
        reg.gauge("tpudl_online_spool_depth").set(source.pending())
        reg.gauge("tpudl_online_staleness_seconds").set(source.staleness_s())
        flight_recorder.progress("online.loop", round=r, done=True)

    # ------------------------------------------------------------ background
    def should_run(self) -> bool:
        cfg = self.config
        if os.path.exists(os.path.join(self._round_dir(self.next_round()),
                                       "round.json")):
            return True          # a killed round is waiting to be resumed
        pending = self._source().pending()   # one spool read per poll
        if pending >= cfg.min_records:
            return True
        with self._round_t_lock:
            last_round_t = self._last_round_t
        if last_round_t and cfg.interval_s > 0 \
                and time.monotonic() - last_round_t >= cfg.interval_s:
            return pending > 0
        return False

    def _run_loop(self) -> None:
        cfg = self.config
        failures = 0
        while not self._stop.is_set():
            flight_recorder.progress("online.loop")
            try:
                if self.should_run():
                    self.run_once()
                    failures = 0
            except Exception as e:
                failures += 1
                flight_recorder.record("online_round",
                                       status="loop_error",
                                       failures=failures,
                                       error=repr(e)[:300])
                log.warning("online loop round failed (%d/%d): %r",
                            failures, cfg.max_consecutive_failures, e)
                if failures > cfg.max_consecutive_failures:
                    # budget burned: leave a black box and stop — the
                    # process-level supervisor (or the operator) decides
                    self.failed = repr(e)
                    flight_recorder.dump(reason="online:loop_failed",
                                         detail={"error": repr(e)[:500],
                                                 "failures": failures})
                    return
                self._stop.wait(min(2.0, 0.5 * 2.0 ** (failures - 1)))
            self._stop.wait(cfg.poll_s)

    def start(self) -> "OnlineTrainer":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        with self._round_t_lock:
            self._last_round_t = time.monotonic()
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name=f"tpudl-online-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "OnlineTrainer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
