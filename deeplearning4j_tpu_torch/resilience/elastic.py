"""Elastic gang resizing, the reversible half of fault tolerance (port
of ``deeplearning4j_tpu/resilience/elastic.py``).

- :class:`ResizeCoordinator`: a thread-safe request → begin →
  commit/abort lifecycle around one width change at a time.  ``request``
  validates at the decision site (the floor, a positive width); ``begin``
  claims the pending decision; ``commit`` makes the new width current and
  stamps the ``tpudl_elastic_*`` series; ``abort`` keeps the old width
  with nothing torn.
- The child's side: :func:`configured_width` (the gang's current width,
  from which a worker derives its data-parallel degree instead of
  hard-coding one) and :func:`is_grown_child` (true only in the
  generation that a grow spawned; ``Trainer.resume_state`` fires the
  ``gang.grow`` site there, so a kill planted mid-reshard lands inside
  the grown child and recovers by the supervisor's respawn).  The JAX
  package reads both from the environment; the port reads the launcher's
  child context (``parallel.launcher.child_context``).

A supervised resize tears the gang down at a round boundary and the gang
at the new width resumes from the newest verified checkpoint
(``resilience.supervisor``); the in-process resize
(``Trainer.request_resize``) re-forms the layout inside the running gang
at its next epoch boundary; either way the data-parallel layout at the new
width is ``parallel.mesh.resize_layout``'s.  ``resilience.arbiter`` moves
devices between serving and training through either.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


def configured_width(default: Optional[int] = None) -> Optional[int]:
    """The gang width the supervisor configured for this process, or
    ``default`` outside a supervised gang."""
    from deeplearning4j_tpu_torch.parallel.launcher import child_context
    width = child_context().gang_width
    return default if width is None else int(width)


def is_grown_child() -> bool:
    """True inside a gang child spawned by a grow."""
    from deeplearning4j_tpu_torch.parallel.launcher import child_context
    return bool(child_context().grown)


@dataclasses.dataclass
class ResizeDecision:
    """One width change moving through the coordinator's lifecycle."""

    kind: str                  # "grow" | "shrink"
    from_width: int
    to_width: int
    reason: str = ""
    seq: int = 0               # the decision's number
    requested_at: float = 0.0  # time.monotonic() at request
    begun_at: float = 0.0      # time.monotonic() at begin (0: not begun)
    outcome: str = ""          # "" in flight | "committed" | "aborted" | "noop"
    flip_s: Optional[float] = None   # begin → commit wall time

    def summary(self) -> str:
        return (f"resize#{self.seq} {self.kind} {self.from_width}→{self.to_width}"
                + (f" ({self.reason})" if self.reason else "")
                + (f" [{self.outcome}]" if self.outcome else ""))


class ResizeCoordinator:
    """The thread-safe, reversible resize state machine.

    One decision moves at a time: ``request`` (any thread) parks a
    validated decision; the executor (the supervisor's watch loop) takes
    it with ``begin``, relaunches, and ends it with ``commit`` (the width
    changes) or ``abort`` (it stays).  A new request replaces a pending
    one not yet begun (latest wins); a request while one is in flight
    raises, since two relaunches would race over the same devices."""

    def __init__(self, width: int, min_width: int = 1,
                 on_event: Optional[Callable[[ResizeDecision], None]] = None):
        if int(width) < 1:
            raise ValueError(f"initial gang width must be >= 1, got {width}")
        self._width = int(width)
        self.min_width = max(1, int(min_width))
        self._on_event = on_event
        self._lock = threading.Lock()
        self._pending: Optional[ResizeDecision] = None
        self._in_flight: Optional[ResizeDecision] = None
        self._seq = 0
        self.history: list[ResizeDecision] = []

    # ------------------------------------------------------------ queries
    @property
    def width(self) -> int:
        with self._lock:
            return self._width

    def pending(self) -> Optional[ResizeDecision]:
        with self._lock:
            return self._pending

    def in_flight(self) -> Optional[ResizeDecision]:
        with self._lock:
            return self._in_flight

    # ---------------------------------------------------------- lifecycle
    def request(self, width: int, reason: str = "") -> ResizeDecision:
        """Park a validated resize for the executor.  An impossible width
        (below the training floor, or not a width) raises ``ValueError``
        here, and nothing is torn down."""
        width = int(width)
        if width < 1:
            raise ValueError(f"gang width must be >= 1, got {width}")
        if width < self.min_width:
            raise ValueError(f"gang width {width} is below the training floor "
                             f"min_width={self.min_width} — the arbiter can never cross it")
        with self._lock:
            if self._in_flight is not None:
                raise ValueError(f"a resize is already in flight ({self._in_flight.summary()}); "
                                 f"commit or abort it before requesting another")
            self._seq += 1
            decision = ResizeDecision(kind="grow" if width > self._width else "shrink",
                                      from_width=self._width, to_width=width, reason=reason,
                                      seq=self._seq, requested_at=time.monotonic())
            if width == self._width:
                # a no-op never enters the queue; the history keeps it
                decision.outcome = "noop"
                self.history.append(decision)
                return decision
            self._pending = decision   # the latest wins over one not begun
            return decision

    def begin(self) -> Optional[ResizeDecision]:
        """Claim the pending decision (None when there is none)."""
        with self._lock:
            decision, self._pending = self._pending, None
            if decision is not None:
                decision.begun_at = time.monotonic()
                self._in_flight = decision
            return decision

    def commit(self, decision: ResizeDecision) -> None:
        """The flip landed: the new width is current.  Stamps the
        ``tpudl_elastic_*`` series and tells ``on_event``."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        with self._lock:
            self._close(decision, "committed")
            self._width = decision.to_width
        reg = get_registry()
        reg.counter("tpudl_elastic_grows_total" if decision.kind == "grow"
                    else "tpudl_elastic_shrinks_total").inc()
        reg.gauge("tpudl_elastic_gang_width").set(decision.to_width)
        if decision.flip_s is not None:
            reg.histogram("tpudl_elastic_flip_seconds").observe(decision.flip_s)
        if self._on_event is not None:
            self._on_event(decision)

    def abort(self, decision: ResizeDecision, reason: str = "") -> None:
        """The flip failed: the width stays where it was."""
        with self._lock:
            self._close(decision, "aborted")
            if reason:
                decision.reason = decision.reason + "; " + reason if decision.reason else reason
        if self._on_event is not None:
            self._on_event(decision)

    def _close(self, decision: ResizeDecision, outcome: str) -> None:
        # the caller holds the lock
        if self._in_flight is not decision:
            raise ValueError(f"{decision.summary()} is not the in-flight resize")
        self._in_flight = None
        decision.outcome = outcome
        decision.flip_s = round(time.monotonic() - decision.begun_at, 6)
        self.history.append(decision)
