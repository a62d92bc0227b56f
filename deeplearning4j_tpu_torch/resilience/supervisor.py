"""Self-healing gangs: a cluster supervisor that survives a worker's
death (port of ``deeplearning4j_tpu/resilience/supervisor.py``).

:class:`ClusterSupervisor` wraps a ``parallel.launcher.GangHandle`` into a
supervised training run:

- **detect**: a dead worker (a nonzero exit, SIGKILL), a stalled one
  (the flight recorder's watchdog, rc 87), or a silent one (its
  liveness age on the coordinator's ``obs.remote.ClusterStore`` past
  ``liveness_timeout_s``);
- **tear down**: every surviving child is asked for its black box
  (SIGUSR1) and then stopped (terminate, a grace period, kill); the
  dumps ride the incident;
- **respawn**: every worker restarts under a fresh ``torch.distributed``
  group (its port shifted per generation), with a child context
  (``parallel.launcher.ChildContext``) that carries its stable worker id
  ``w<slot>``, the generation, the gang's width and, when a verified
  checkpoint exists under ``checkpoint_dir``, the resume pointer that
  ``Trainer.fit`` takes; a fault plan is given to generation 0 only;
- **bound**: restarts are budgeted per worker slot, with
  ``RetryPolicy``'s backoff between them; past ``max_restarts`` on one
  slot the ``degradation`` policy decides: ``"shrink"`` drops the slot
  and goes on with the rest (floored at ``min_workers``), ``"halt"``
  raises :class:`GangFailedError` with every incident's dumps;
- **measure**: each incident's MTTR (detection to the first federated
  step of the new generation) and steps replayed (the last iteration
  before the crash less the iteration resumed), into
  ``tpudl_resilience_gang_restarts_total`` and
  ``tpudl_resilience_gang_mttr_seconds``;
- **resize**: :meth:`ClusterSupervisor.request_resize` relaunches the
  gang at a new width at its next poll, from the newest verified
  checkpoint, through ``resilience.elastic``'s state machine (a
  degradation shrink goes through it too).

The JAX package hands a child these facts in environment variables; the
port puts them into each child's pickled call.  Not ported yet: the
artifact store's warm restart (``artifact_bake``; ``ROADMAP.md`` queue A
item 3).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional, Union

from deeplearning4j_tpu_torch.resilience import elastic
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy

_ARTIFACT_ITEM = ("ROADMAP.md queue A item 3 (train/artifact_store.py, the compiled-artifact "
                  "store)")


def _watchdog_stall_rc() -> int:
    from deeplearning4j_tpu_torch.obs import flight_recorder
    return flight_recorder.WATCHDOG_EXIT_CODE


@dataclasses.dataclass
class GangIncident:
    """One detected gang failure and what recovery did about it."""

    generation: int
    reason: str                       # killed | crashed | stalled | liveness_stall
    exits: list                       # [(worker slot, rc)] of the dead or stalled
    detected_at: float                # unix time of detection
    stderr_tails: list
    flight_dumps: dict                # child pid → parsed black-box lines
    pre_crash_iterations: dict        # worker id → last federated iteration
    resumed_from: Optional[str] = None   # the newest verified checkpoint zip
    restarted: bool = False
    degraded_to: Optional[list] = None   # the slots left after a shrink
    mttr_s: Optional[float] = None
    steps_replayed: Optional[int] = None

    def summary(self) -> str:
        exits = ", ".join(f"slot {s} rc={rc}" for s, rc in self.exits) or "none"
        return (f"generation {self.generation}: {self.reason} ({exits}); "
                f"{len(self.flight_dumps)} flight dump(s); restarted={self.restarted}"
                + (f" degraded_to={self.degraded_to}" if self.degraded_to is not None else "")
                + (f" mttr_s={self.mttr_s}" if self.mttr_s is not None else "")
                + (f" steps_replayed={self.steps_replayed}"
                   if self.steps_replayed is not None else ""))


class GangFailedError(RuntimeError):
    """The supervised run is over: a slot's restart budget is spent (or
    the degradation floor is hit).  ``incidents`` carries the whole
    history, each with its black boxes, and ``flight_dumps`` flattens
    every dump as ``"g<generation>:p<pid>"``."""

    def __init__(self, message: str, incidents: list):
        super().__init__(message)
        self.incidents = list(incidents)
        self.flight_dumps = {f"g{inc.generation}:p{pid}": dump for inc in self.incidents
                             for pid, dump in inc.flight_dumps.items()}


@dataclasses.dataclass
class SupervisedRun:
    """A completed supervised run: the last gang's results and the
    recovery history that got there."""

    results: list
    incidents: list
    generations: int          # gangs spawned (1: no restart)
    slots: list               # the worker slots alive at the end

    @property
    def recovered(self) -> bool:
        return bool(self.incidents)


class ClusterSupervisor:
    """Supervise ``fn(process_index, process_count)`` as a restartable
    local gang (the module docstring).  ``fn`` must pickle (a module-level
    function, or a ``functools.partial`` of one).  ``device`` is the
    children's (``spawn_local_cluster``'s).  ``fault_plan`` is a
    ``resilience.faults`` spec for every child, or a dict of one per
    slot, given to generation 0 only (``clear_fault_plan_on_restart``), so
    that a planted death fires once.  ``cluster_store`` (the coordinator
    ``UIServer``'s store) unlocks liveness detection and the MTTR and
    steps-replayed readings; without it MTTR runs to the respawn.
    ``artifact_bake`` must be None: the compiled-artifact store is not
    ported yet."""

    def __init__(self, fn: Callable, n_processes: int = 2, checkpoint_dir: Optional[str] = None,
                 max_restarts: int = 2, degradation: str = "halt", min_workers: int = 1,
                 port: int = 12955, device=None, timeout: float = 300.0,
                 gang_deadline: Optional[float] = None, extra_env: Optional[dict] = None,
                 remote_ui: Optional[str] = None, cluster_store=None,
                 liveness_timeout_s: Optional[float] = None,
                 backoff: Optional[RetryPolicy] = None, poll_s: float = 0.1,
                 clear_fault_plan_on_restart: bool = True, mttr_wait_s: float = 60.0,
                 fault_plan: Union[None, str, dict] = None,
                 artifact_bake: Optional[bool] = None):
        if degradation not in ("halt", "shrink"):
            raise ValueError(f"degradation must be 'halt' or 'shrink', got {degradation!r}")
        if artifact_bake is not None:
            raise NotImplementedError(f"artifact_bake: the compiled-artifact store is not "
                                      f"ported yet; {_ARTIFACT_ITEM} ports it")
        self.fn = fn
        self.n_processes = int(n_processes)
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = int(max_restarts)
        self.degradation = degradation
        self.min_workers = max(1, int(min_workers))
        self.port = int(port)
        self.device = device
        self.timeout = float(timeout)
        self.gang_deadline = gang_deadline
        self.extra_env = dict(extra_env or {})
        self.remote_ui = remote_ui
        self.cluster_store = cluster_store
        self.liveness_timeout_s = liveness_timeout_s
        # the backoff between respawns: RetryPolicy's schedule, keyed by
        # the restart attempt
        self.backoff = backoff or RetryPolicy(max_attempts=self.max_restarts + 1,
                                              base_delay_s=0.2, max_delay_s=5.0, jitter=0.25)
        self.poll_s = float(poll_s)
        self.clear_fault_plan_on_restart = clear_fault_plan_on_restart
        self.mttr_wait_s = float(mttr_wait_s)
        self.fault_plan = fault_plan
        # elastic resizing: request_resize (any thread) parks a decision;
        # the watch loop takes it at its next poll, the round boundary
        # where the gang relaunches at the new width
        self._resize = elastic.ResizeCoordinator(width=self.n_processes,
                                                 min_width=self.min_workers,
                                                 on_event=self._on_resize_event)

    # ------------------------------------------------------------ elastic
    @property
    def width(self) -> int:
        """The gang's current width (after resizes and degradation)."""
        return self._resize.width

    def request_resize(self, width: int, reason: str = "") -> None:
        """Relaunch the running gang at ``width`` workers (grow or shrink)
        at its next round boundary, every slot resuming from the newest
        verified checkpoint.  Thread-safe; a width below ``min_workers``
        raises here and the gang runs on untouched."""
        self._resize.request(width, reason=reason)

    def _on_resize_event(self, decision) -> None:
        if self.cluster_store is None:
            return
        try:
            self.cluster_store.annotate("resize", decision.summary(), direction=decision.kind,
                                        from_width=decision.from_width,
                                        to_width=decision.to_width, outcome=decision.outcome,
                                        flip_s=decision.flip_s)
        except Exception:
            pass

    # ------------------------------------------------------------- pieces
    def _latest_checkpoint(self) -> Optional[str]:
        """The newest VERIFIED checkpoint zip under ``checkpoint_dir``, in
        it or one level down (a ``w<slot>/`` per worker); None when nothing
        intact is there (the respawned gang then starts over, which
        replays everything and stays exact)."""
        if self.checkpoint_dir is None:
            return None
        from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
        found = CheckpointListener.last_checkpoint_in(self.checkpoint_dir)
        if found:
            return found
        try:
            subs = sorted(os.listdir(self.checkpoint_dir))
        except OSError:
            return None
        for sub in subs:
            d = os.path.join(self.checkpoint_dir, sub)
            if os.path.isdir(d):
                found = CheckpointListener.last_checkpoint_in(d)
                if found:
                    return found
        return None

    def _plan_for(self, slot: int) -> Optional[str]:
        if isinstance(self.fault_plan, dict):
            return self.fault_plan.get(slot)
        return self.fault_plan

    def _child_env(self, generation: int, slots: list, resume: Optional[str],
                   grown: bool = False) -> Callable[[int], dict]:
        """The per-child context hook for the ``GangHandle``: the stable
        worker id (``w<slot>``), the generation, the gang's width, the
        grown flag (only in a grow's generation, so that the ``gang.grow``
        site fires in exactly those children), the resume pointer (when a
        verified checkpoint exists) and the fault plan (generation 0 only,
        unless ``clear_fault_plan_on_restart`` is off, so that the drill
        that killed generation N cannot kill generation N+1)."""
        def env_for(pid: int) -> dict:
            ctx = {"worker": f"w{slots[pid]}", "generation": generation,
                   "gang_width": len(slots), "grown": bool(grown),
                   "remote_ui": self.remote_ui}
            if resume is not None and self.checkpoint_dir is not None:
                ctx["resume_from"] = self.checkpoint_dir
            if generation == 0 or not self.clear_fault_plan_on_restart:
                plan = self._plan_for(slots[pid])
                if plan:
                    ctx["fault_plan"] = plan
            return ctx
        return env_for

    def _spawn(self, generation: int, slots: list, resume: Optional[str], grown: bool = False):
        from deeplearning4j_tpu_torch.parallel.launcher import GangHandle
        gang_deadline, gang_fires = self.gang_deadline, 1
        if gang_deadline is None:
            # spawn_local_cluster's default: one free fire, so that a slow
            # first step costs a dump, not a spurious restart
            gang_deadline = max(5.0, (self.timeout - 15.0) / 2.0)
            gang_fires = 2
        elif gang_deadline <= 0:
            gang_deadline = None
        # a fresh coordinator port per generation: the dead gang's socket
        # lingers in TIME_WAIT
        return GangHandle(self.fn, len(slots), self.port + generation * 97, device=self.device,
                          timeout=self.timeout, extra_env=self.extra_env,
                          gang_deadline=gang_deadline, gang_fires=gang_fires,
                          remote_ui=self.remote_ui,
                          child_env=self._child_env(generation, slots, resume, grown=grown))

    @staticmethod
    def _classify(failed: list) -> str:
        rcs = [rc for _, rc in failed]
        if any(rc == _watchdog_stall_rc() for rc in rcs):
            return "stalled"
        if any(rc is not None and rc < 0 for rc in rcs):
            return "killed"
        return "crashed"

    def _store_summary(self) -> dict:
        if self.cluster_store is None:
            return {}
        try:
            return self.cluster_store.summary().get("workers", {})
        except Exception:
            return {}

    def _stalled_workers(self, generation: int, slots: list) -> list:
        """The current generation's workers whose liveness age is past
        ``liveness_timeout_s`` after they reported once: the stall the
        watchdog missed."""
        if self.liveness_timeout_s is None or self.cluster_store is None:
            return []
        expected = {f"w{slot}" for slot in slots}
        return sorted(name for name, w in self._store_summary().items()
                      if name in expected and w.get("generation") == generation
                      and w.get("steps", 0) >= 1
                      and w.get("liveness_age_s", 0) > self.liveness_timeout_s)

    def _watch(self, handle, generation: int, slots: list) -> Optional[dict]:
        """Block until the gang finishes (None) or a member dies or stalls
        (the facts).  A gang past its wall budget raises
        ``ClusterTimeoutError``: not an incident (a rerun would spend the
        timeout again)."""
        while True:
            if time.monotonic() > handle.deadline:
                raise handle.abort_timeout(
                    f"supervised gang (generation {generation}) overran its "
                    f"{handle.timeout:.0f}s wall budget; all children stopped:")
            exits = handle.poll_exits()
            failed = [(pid, rc) for pid, rc in exits.items() if rc is not None and rc != 0]
            if failed:
                return {"failed": failed, "reason": self._classify(failed)}
            if all(rc == 0 for rc in exits.values()):
                return None
            stalled = self._stalled_workers(generation, slots)
            if stalled:
                return {"failed": [], "stalled_workers": stalled, "reason": "liveness_stall"}
            if self._resize.pending() is not None:
                # a requested resize: a planned round boundary, not an incident
                return {"failed": [], "reason": "resize"}
            time.sleep(self.poll_s)

    def _make_incident(self, handle, generation: int, slots: list, failure: dict,
                       resume: Optional[str]) -> GangIncident:
        from deeplearning4j_tpu_torch.obs import flight_recorder
        # the iterations before the crash, before teardown: the respawned
        # workers register under a fresh generation and the store resets
        pre = {name: w.get("iteration") for name, w in self._store_summary().items()}
        # evidence first, the stop second: SIGUSR1 makes every surviving
        # sibling dump its black box
        handle.request_dumps()
        tails = handle.shutdown()
        dumps = handle.collect_flight_dumps()
        if failure["failed"]:
            exits = [(slots[pid], rc) for pid, rc in failure["failed"]]
        else:
            exits = [(int(name[1:]), None) for name in failure.get("stalled_workers", [])
                     if name.startswith("w") and name[1:].isdigit()]
        incident = GangIncident(generation=generation, reason=failure["reason"], exits=exits,
                                detected_at=time.time(), stderr_tails=tails, flight_dumps=dumps,
                                pre_crash_iterations=pre, resumed_from=resume)
        flight_recorder.record("gang_incident", generation=generation, reason=incident.reason,
                               exits=[list(e) for e in exits])
        return incident

    def _apply_budget(self, failed_slots: list, slots: list, restarts: dict) -> tuple:
        """The restart, shrink or halt decision, bookkeeping only (no
        spawn): charges one restart to each failed slot and returns
        ``("restart", slots)``, ``("shrink", the slots left)`` or
        ``("halt", slots)``."""
        for slot in failed_slots:
            restarts[slot] = restarts.get(slot, 0) + 1
        over = [s for s in failed_slots if restarts[s] > self.max_restarts]
        if not over:
            return "restart", list(slots)
        if self.degradation == "shrink":
            surviving = [s for s in slots if s not in over]
            if len(surviving) >= self.min_workers:
                return "shrink", surviving
        return "halt", list(slots)

    def _stamp_recovery(self, incident: GangIncident, generation: int, t_detect: float,
                        handle=None) -> None:
        """MTTR and steps replayed for the incident that the new
        generation recovers from.  With a cluster store: wait (bounded)
        for the new generation's first federated step, then read each
        worker's resume point; without one, MTTR runs to the respawn.  The
        wait ends early when a respawned child dies, so that a gang that
        fails again at once falls through to the watch."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        if self.cluster_store is not None:
            deadline = time.monotonic() + self.mttr_wait_s
            while time.monotonic() < deadline:
                if any(w.get("generation") == generation and w.get("steps", 0) >= 1
                       for w in self._store_summary().values()):
                    break
                if handle is not None and any(rc not in (None, 0)
                                              for rc in handle.poll_exits().values()):
                    break
                time.sleep(0.05)
            replayed = []
            for name, w in self._store_summary().items():
                if w.get("generation") != generation:
                    continue
                resumed = w.get("resumed_iteration")
                pre = incident.pre_crash_iterations.get(name)
                if resumed is not None and isinstance(pre, int):
                    # pre: the last step before the crash; resumed: the
                    # first step run again; replayed: [resumed, pre]
                    replayed.append(max(0, pre - int(resumed) + 1))
            if replayed:
                incident.steps_replayed = max(replayed)
        mttr = time.monotonic() - t_detect
        incident.mttr_s = round(mttr, 3)
        get_registry().histogram("tpudl_resilience_gang_mttr_seconds").observe(mttr)

    # ---------------------------------------------------------------- run
    def run(self) -> SupervisedRun:
        """Run the supervised gang to its end (or exhaustion).  Returns a
        :class:`SupervisedRun`; raises :class:`GangFailedError` when the
        budget or the degradation floor is spent."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        from deeplearning4j_tpu_torch.parallel.launcher import prepare_devices
        reg = get_registry()
        prepare_devices(self.device)
        slots = list(range(self.n_processes))
        restarts: dict = {}
        generation = 0
        incidents: list = []
        pending: Optional[tuple] = None   # (incident, detection monotonic)
        resize_flip = None                # the ResizeDecision in flight
        grown_spawn = False               # the next spawn is a grow's generation
        while True:
            resume = self._latest_checkpoint()
            handle = self._spawn(generation, slots, resume, grown=grown_spawn)
            grown_spawn = False
            if resize_flip is not None:
                # the gang at the new width is up: the flip landed
                self._resize.commit(resize_flip)
                resize_flip = None
            if self.cluster_store is not None:
                try:
                    self.cluster_store.set_gang_width(len(slots))
                except Exception:
                    pass
            try:
                if pending is not None:
                    incident, t_detect = pending
                    self._stamp_recovery(incident, generation, t_detect, handle=handle)
                    pending = None
                failure = self._watch(handle, generation, slots)
            except BaseException:
                handle.shutdown()
                raise
            if failure is None:
                return SupervisedRun(results=handle.results(), incidents=incidents,
                                     generations=generation + 1, slots=slots)
            if failure["reason"] == "resize":
                # a planned round boundary: stop the gang (its checkpoint
                # listeners wrote verified zips) and relaunch at the new
                # width; a grow resets every slot's budget
                decision = self._resize.begin()
                handle.shutdown()
                if decision is None:
                    continue
                slots = list(range(decision.to_width))
                if decision.kind == "grow":
                    restarts = {}
                    grown_spawn = True
                resize_flip = decision
                generation += 1
                continue
            t_detect = time.monotonic()
            incident = self._make_incident(handle, generation, slots, failure, resume)
            incidents.append(incident)
            failed_slots = [slot for slot, _ in incident.exits] or list(slots)
            decision, slots = self._apply_budget(failed_slots, slots, restarts)
            if decision == "halt":
                raise GangFailedError(
                    f"supervised gang failed permanently after {len(incidents)} incident(s) "
                    f"(max_restarts={self.max_restarts}/slot, degradation={self.degradation}):\n"
                    + "\n".join(i.summary() for i in incidents), incidents)
            if decision == "shrink":
                incident.degraded_to = list(slots)
                # through the same state machine as a requested resize, so
                # that the width stays true and a later request can grow back
                d = self._resize.request(len(slots), reason="degradation")
                if d.outcome != "noop":
                    self._resize.commit(self._resize.begin())
            incident.restarted = True
            reg.counter("tpudl_resilience_gang_restarts_total").inc()
            attempt = max(restarts.get(s, 1) for s in failed_slots)
            time.sleep(self.backoff.delay_for(attempt, "supervisor.restart"))
            generation += 1
            pending = (incident, t_detect)


def supervise(fn: Callable, **kwargs: Any) -> SupervisedRun:
    """The one-call form: ``supervise(worker_fn, n_processes=4, ...)``."""
    return ClusterSupervisor(fn, **kwargs).run()
