"""DevicePoolArbiter: one owner for a host's cards, two tenants (port of
``deeplearning4j_tpu/resilience/arbiter.py``).

Serving and training pressure on the same cards is the steady state of a
production fleet: a traffic spike borrows training cards (the gang
shrinks at its next round boundary), and when pressure ebbs the cards flow
back and the gang grows to its old width, so capacity degrades gracefully
in both directions.

The arbiter owns the inventory and never guesses at load: the
autoscaler (``serve.autoscale.Autoscaler(router, arbiter=...)``) calls
:meth:`DevicePoolArbiter.note_pressure` once a poll with the router's
queue fill and a ``saturated`` flag (replica scaling hit ``max_replicas``
and the pressure persists), the point where only cards help.

Decision discipline, the JAX package's:

- hysteresis: a borrow needs ``sustain_polls`` saturated-high polls in a
  row, a return as many calm ones, and ``cooldown_s`` separates any two
  flips;
- the training floor: the gang never shrinks below ``min_train``; a borrow
  that would cross it is refused at the decision site;
- retry and rollback: every flip runs under ``resilience.retry.
  with_retries`` (a transient ``InjectedFault`` backs off and flips again)
  and a partial flip is rolled back, undoing only what the attempt did,
  before the error surfaces, so the inventory is exactly conserved: a crash
  at the ``arbiter.borrow`` / ``arbiter.return`` sites (between the gang's
  request and the serving side's change) aborts the flip with both
  tenants' counts unchanged.

The gang side is anything with a ``width`` and ``request_resize(width,
reason=...)``: a ``resilience.supervisor.ClusterSupervisor``, or
:class:`TrainerGang` over an in-process ``Trainer`` whose layout resizes
at its next epoch boundary (``Trainer.resize_mesh``; the arbiter then lives
in rank 0's process, beside the router).  The series are the JAX
package's: ``tpudl_elastic_pool_devices{owner}``,
``tpudl_elastic_borrows_total``, ``tpudl_elastic_returns_total`` and
``tpudl_elastic_flip_seconds``; each flip is a flight event and an
annotation on the cluster store.
"""

from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_tpu_torch.obs import flight_recorder
from deeplearning4j_tpu_torch.obs import remote as obs_remote
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, with_retries


class TrainerGang:
    """The arbiter's gang side over an in-process layout ``Trainer`` (in
    rank 0's process): the trainer resizes itself at its next epoch
    boundary instead of a supervisor relaunching children.  ``width`` is
    the pending width, else the layout's."""

    def __init__(self, trainer):
        if trainer._layout is None:
            raise ValueError("TrainerGang needs a mesh/layout-configured "
                             "Trainer (no width to arbitrate otherwise)")
        self.trainer = trainer

    @property
    def width(self) -> int:
        pending = self.trainer._pending_resize
        return int(pending if pending is not None
                   else self.trainer._layout.spec.total())

    def request_resize(self, width: int, reason: str = "") -> None:
        self.trainer.request_resize(width)


class DevicePoolArbiter:
    """Move devices between one serving router and one training gang."""

    def __init__(self, router, gang, *,
                 min_train: int = 1,
                 chips_per_flip: int = 1,
                 high_water: float = 0.5,
                 low_water: float = 0.05,
                 sustain_polls: int = 3,
                 cooldown_s: float = 0.5,
                 serve_chips: Optional[int] = None,
                 policy: Optional[RetryPolicy] = None,
                 cluster_store=None):
        if chips_per_flip < 1:
            raise ValueError(f"chips_per_flip must be >= 1, "
                             f"got {chips_per_flip}")
        self.router = router
        self.gang = gang
        self.min_train = max(1, int(min_train))
        self.chips_per_flip = int(chips_per_flip)
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.sustain_polls = max(1, int(sustain_polls))
        self.cooldown_s = float(cooldown_s)
        self.policy = policy or RetryPolicy(max_attempts=3,
                                            base_delay_s=0.02,
                                            max_delay_s=0.5)
        self.cluster_store = cluster_store
        # the inventory the arbiter owns: devices per tenant.  serve's
        # starting count defaults to the router's replica count (one
        # device per replica on the local fleet)
        self.inventory = {
            "serve": int(serve_chips if serve_chips is not None
                         else getattr(router, "replicas", None)
                         or router.max_replicas),
            "train": int(gang.width),
        }
        self.borrowed = 0           # train devices currently serving
        self._high_streak = 0
        self._low_streak = 0
        self._last_flip = 0.0
        self._publish()

    # ----------------------------------------------------------- plumbing
    def total(self) -> int:
        """Devices under arbitration: conserved across every flip."""
        return self.inventory["serve"] + self.inventory["train"]

    def snapshot(self) -> dict:
        return {**self.inventory, "borrowed": self.borrowed,
                "total": self.total()}

    def _publish(self) -> None:
        g = get_registry().labeled_gauge("tpudl_elastic_pool_devices",
                                         label_names=("owner",))
        for owner, n in self.inventory.items():
            g.set(n, owner=owner)

    def _annotate(self, kind: str, message: str, **facts) -> None:
        flight_recorder.record("arbiter", event=kind, message=message,
                               **facts)
        store = self.cluster_store
        if store is None:
            store = getattr(self.gang, "cluster_store", None)
        if store is not None:
            try:
                store.annotate("arbiter", message, event=kind, **facts)
            except Exception:
                pass
        obs_remote.notify_event("arbiter", event=kind, **facts)

    # ----------------------------------------------------------- pressure
    def note_pressure(self, fill: float,
                      saturated: bool = False) -> Optional[str]:
        """One pressure observation from the autoscaler's poll loop.
        Returns the flip it performed (``"borrow"`` / ``"return"``) or
        None — the hysteresis windows and cooldown make this safe to
        call at any poll rate."""
        if saturated and fill >= self.high_water:
            self._high_streak += 1
            self._low_streak = 0
        elif fill <= self.low_water:
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = 0
            self._low_streak = 0
        now = time.monotonic()
        if now - self._last_flip < self.cooldown_s:
            return None
        if self._high_streak >= self.sustain_polls:
            self._high_streak = 0
            if self.borrow():
                return "borrow"
        elif self._low_streak >= self.sustain_polls and self.borrowed > 0:
            self._low_streak = 0
            if self.return_chips():
                return "return"
        return None

    # -------------------------------------------------------------- flips
    def borrow(self, n: Optional[int] = None) -> bool:
        """Move ``n`` devices train → serve (the gang shrinks at its next
        round boundary, serving capacity rises now).  Refused (False,
        nothing torn down) when the training floor would be crossed."""
        n = int(n if n is not None else self.chips_per_flip)
        target = self.inventory["train"] - n
        if n < 1 or target < self.min_train:
            self._annotate("borrow_refused",
                           f"borrow of {n} refused: train would drop to "
                           f"{target} (< floor {self.min_train})",
                           n=n, floor=self.min_train)
            return False
        return self._flip("borrow", n)

    def return_chips(self, n: Optional[int] = None) -> bool:
        """Move ``n`` devices serve → train (default: everything
        borrowed); the gang grows back at its next round boundary."""
        n = int(n if n is not None else self.borrowed)
        if n < 1 or n > self.borrowed:
            return False
        return self._flip("return", n)

    def _flip(self, kind: str, n: int) -> bool:
        t0 = time.perf_counter()
        try:
            with_retries(lambda: self._flip_once(kind, n),
                         policy=self.policy, site=f"arbiter.{kind}")
        except Exception as e:
            # rolled back inside _flip_once: the inventory is exactly
            # what it was before the flip (conservation is the test)
            self._annotate(f"{kind}_aborted",
                           f"{kind} of {n} chip(s) aborted: {e!r:.200}",
                           n=n, **self.snapshot())
            return False
        flip_s = time.perf_counter() - t0
        delta = n if kind == "borrow" else -n
        self.inventory["serve"] += delta
        self.inventory["train"] -= delta
        self.borrowed += delta
        self._last_flip = time.monotonic()
        reg = get_registry()
        reg.counter(f"tpudl_elastic_{kind}s_total").inc()
        reg.histogram("tpudl_elastic_flip_seconds").observe(flip_s)
        self._publish()
        self._annotate(kind,
                       f"{kind} {n} chip(s): serve={self.inventory['serve']} "
                       f"train={self.inventory['train']}",
                       n=n, flip_s=round(flip_s, 4), **self.snapshot())
        return True

    def _flip_once(self, kind: str, n: int) -> None:
        """One flip attempt: gang resize request + serve capacity move,
        with full rollback on any failure so a crash mid-flip leaves
        both tenants exactly as they were.  The ``arbiter.borrow`` /
        ``arbiter.return`` fault sites fire between the gang request
        and the serve-side mutation — the worst possible instant."""
        train = self.inventory["train"]
        if kind == "borrow":
            self.gang.request_resize(train - n, reason="arbiter borrow")
            added, raised = 0, 0
            try:
                faults.fire("arbiter.borrow")
                self.router.max_replicas += n
                raised = n
                for _ in range(n):
                    if self.router.add_replica():
                        added += 1
            except BaseException:
                # undo ONLY what this attempt actually did — a crash at
                # the fault site must not shrink a cap it never raised
                for _ in range(added):
                    self.router.retire_replica()
                self.router.max_replicas -= raised
                self._unrequest(train)
                raise
        else:
            self.gang.request_resize(train + n, reason="arbiter return")
            retired, lowered = 0, 0
            try:
                faults.fire("arbiter.return")
                for _ in range(n):
                    if self.router.retire_replica():
                        retired += 1
                new_cap = max(self.router.min_replicas,
                              self.router.max_replicas - n)
                lowered = self.router.max_replicas - new_cap
                self.router.max_replicas = new_cap
            except BaseException:
                self.router.max_replicas += lowered
                for _ in range(retired):
                    self.router.add_replica()
                self._unrequest(train)
                raise

    def _unrequest(self, width: int) -> None:
        """Best-effort rollback of a gang resize request (the request
        is still pending at its round boundary in the common case; a
        resize already in flight refuses the replacement — the gang
        then settles at the requested width and the NEXT arbitration
        pass reconciles)."""
        try:
            self.gang.request_resize(width, reason="arbiter rollback")
        except Exception:
            pass
