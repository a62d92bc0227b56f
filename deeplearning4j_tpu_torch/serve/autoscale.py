"""Queue-depth-driven replica autoscaling for the serve router (port of
``deeplearning4j_tpu/serve/autoscale.py``).

The router's aggregate queue-fill fraction is the one pressure signal
that is always truthful under micro-batching: latency lags load (the
deadline flush hides pressure until queues build) and CPU/device
utilization lies under bucketing (a padded batch burns the same cycles
at any fill).  Queue fill leads both — requests waiting are requests
someone is already waiting on.

:class:`Autoscaler` polls
:meth:`~deeplearning4j_tpu_torch.serve.router.ReplicaRouter.queue_fill` on a
background thread and

- **scales up** one replica per poll while fill >= ``scale_up_at``
  (bounded by the router's ``max_replicas`` and ``up_cooldown_s``) —
  cheap, because a new replica shares the step-cached captured forward:
  milliseconds, never a recapture;
- **scales down** one replica per poll while fill <= ``scale_down_at``
  (bounded by ``min_replicas`` and ``down_cooldown_s``) — retiring
  ALWAYS drains: the victim stops receiving dispatches, serves what it
  already queued, then its engine goes away.  Nothing is dropped to
  save a thread;
- **heals** — replicas whose engine died are replaced every poll
  (per-replica health, counted through the same scale metrics).

Scaling races a fan-out hot-swap safely by construction: the router's
structural lock orders replica-set changes against engine flips, and a
replica added mid-swap is born on the new version.

Scale events ride ``tpudl_router_scale_{ups,downs}_total`` and the
flight-recorder ring; the replica count is ``tpudl_router_replicas``.
See docs/serving.md "Scale-out" for the knob table.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from deeplearning4j_tpu_torch.serve.router import ReplicaRouter


@dataclasses.dataclass
class AutoscaleConfig:
    """Knobs for :class:`Autoscaler` (docs/serving.md has the table)."""

    scale_up_at: float = 0.25     # aggregate queue-fill fraction
    scale_down_at: float = 0.02
    poll_s: float = 0.05
    up_cooldown_s: float = 0.0    # min seconds between scale-ups
    down_cooldown_s: float = 1.0  # ... and between scale-downs
    # decisions use the MAX fill over this many recent polls: the
    # engine drains its queue into the forming batch between flushes,
    # so an instantaneous sample routinely reads 0 under real pressure
    # — the peak over a short window is the truthful signal (and makes
    # scale-DOWN conservative: the window must be calm throughout)
    window: int = 10


class Autoscaler:
    """Background scaling loop over one :class:`ReplicaRouter`."""

    def __init__(self, router: ReplicaRouter,
                 config: AutoscaleConfig = None, arbiter=None):
        self.router = router
        self.config = config or AutoscaleConfig()
        # escalation path beyond replicas: when an up-decision hits the
        # router's max_replicas ceiling and pressure persists, an
        # arbiter (anything with note_pressure(fill, saturated=)) can
        # move devices from training; the autoscaler reports what it sees
        self.arbiter = arbiter
        self._stop = threading.Event()
        # decision state shared between the poll thread and direct
        # step() callers (tests, the bench): guarded by _lock — the
        # scale calls themselves (which drain engines) run OUTSIDE it
        self._lock = threading.Lock()
        self._last_up = 0.0
        self._last_down = 0.0
        self._fills: collections.deque = collections.deque(
            maxlen=max(1, int(self.config.window)))
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"tpudl-autoscale-{router.name}")
        self._thread.start()

    def step(self) -> None:
        """One scaling decision (the loop body — callable directly from
        tests and the bench for deterministic scaling)."""
        cfg = self.config
        self.router.heal()
        now = time.monotonic()
        with self._lock:
            self._fills.append(self.router.queue_fill())
            fill = max(self._fills)
            up = fill >= cfg.scale_up_at \
                and now - self._last_up >= cfg.up_cooldown_s
            down = not up and fill <= cfg.scale_down_at \
                and now - self._last_down >= cfg.down_cooldown_s
        saturated = False
        if up:
            if self.router.add_replica():
                with self._lock:
                    self._last_up = now
                    # a fresh replica changes the denominator — judge
                    # the new size on its own samples
                    self._fills.clear()
            else:
                # replica scaling is spent (max_replicas) while pressure
                # persists — the signal the chip arbiter escalates on
                saturated = True
        elif down and self.router.retire_replica():
            with self._lock:
                self._last_down = now
                self._fills.clear()
        if self.arbiter is not None:
            self.arbiter.note_pressure(fill, saturated=saturated)

    def _run(self) -> None:
        from deeplearning4j_tpu_torch.obs import flight_recorder
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:
                # scaling must never kill its own loop; the router stays
                # at its current size until the next poll succeeds —
                # but the failure is visible in the black box
                flight_recorder.record("autoscale_error",
                                       model=self.router.name,
                                       error=repr(e)[:200])
            self._stop.wait(self.config.poll_s)

    def close(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout_s)

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
