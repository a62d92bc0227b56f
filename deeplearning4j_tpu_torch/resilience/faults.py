"""Deterministic fault injection (port of
``deeplearning4j_tpu/resilience/faults.py``): the harness that keeps
resilience honest.

A :class:`FaultPlan` is a list of :class:`FaultRule`\\ s, each naming an
instrumented **site** (``trainer.step``, ``dcn.exchange``,
``feeder.stage``, ``checkpoint.write``, ``launcher.spawn``, and the
elastic-pool sites ``gang.grow``, ``arbiter.borrow``,
``arbiter.return``), the event index at which it fires, and an action:

- ``crash``     — raise :class:`InjectedCrash` (a process-death stand-in;
  **not** retryable, it must propagate out of retry loops the way a
  ``kill -9`` propagates out of everything)
- ``error``     — raise :class:`InjectedFault` (a transient failure;
  classified retryable so retry policies exercise their real path)
- ``delay``     — sleep ``arg`` seconds (a slow DCN exchange / stuck ETL)
- ``truncate``  — chop ``arg`` bytes off the end of the file a site just
  published (torn-disk simulation; applied by :func:`corrupt`)
- ``nan``       — poison the site's next reported value (a numeric
  blowup stand-in: the trainer replaces the step's loss with NaN so the
  health-monitor detection path runs end-to-end; checked by
  :func:`poison`, never raises)
- ``kill``      — ``SIGKILL`` this process (REAL gang death, not a
  Python exception: no handler runs, no black box is written — exactly
  what a preemption or OOM-kill looks like to the supervisor)
- ``sigterm``   — ``SIGTERM`` this process (a polite eviction: the
  flight-recorder handler gets to dump before the default action kills)

Plans come from code only (``install_fault_plan`` / the :func:`inject`
context manager); the port reads no environment for them::

    with faults.inject("serve.dispatch@2:error"):
        ...

Spec grammar (the JAX package's, exactly): ``site@index:action[:arg[:times]]`` joined by ``;``.
Sites count their own events (0-based) unless the instrumentation point
passes an explicit index (the trainer passes ``net.iteration`` so a rule
fires at a *global step*, not a per-process call count).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time
from typing import Optional


class InjectedFault(RuntimeError):
    """A deterministic injected failure (transient — retry policies
    classify it retryable)."""


class InjectedCrash(InjectedFault):
    """An injected process death.  NOT retryable: it must tear through
    retry loops and surface exactly like a real preemption."""


@dataclasses.dataclass
class FaultRule:
    site: str
    at: int                 # first event index (within the site) to fire on
    action: str     # crash | error | delay | truncate | nan | kill | sigterm
    arg: float = 0.0        # delay seconds / bytes to truncate
    times: int = 1          # consecutive events to fire on

    def matches(self, index: int) -> bool:
        return self.at <= index < self.at + self.times


class FaultPlan:
    """Deterministic per-site fault schedule.  Thread-safe: sites fire
    from trainer threads, feeder producer threads and DCN IO pools."""

    def __init__(self, rules: Optional[list[FaultRule]] = None):
        self.rules = list(rules or [])
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ parsing
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``site@index:action[:arg[:times]];...`` → plan."""
        rules = []
        for part in spec.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                head, _, tail = part.partition(":")
                site, _, at = head.partition("@")
                bits = tail.split(":") if tail else []
                action = bits[0] if bits else "error"
                arg = float(bits[1]) if len(bits) > 1 else 0.0
                times = int(bits[2]) if len(bits) > 2 else 1
                rules.append(FaultRule(site.strip(), int(at), action.strip(),
                                       arg, times))
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad fault rule {part!r} (want "
                    f"site@index:action[:arg[:times]]): {e}") from e
        return cls(rules)

    # ------------------------------------------------------------- firing
    def _next_index(self, key: str) -> int:
        with self._lock:
            index = self._counts.get(key, 0)
            self._counts[key] = index + 1
            return index

    def _record(self, rule: FaultRule) -> None:
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        get_registry().counter(
            "tpudl_resilience_faults_injected_total").inc()

    def fire(self, site: str, index: Optional[int] = None) -> None:
        """Run the site's non-file actions for this event: ``delay``
        sleeps, ``error``/``crash`` raise, ``kill``/``sigterm`` signal
        this process dead.  ``index`` overrides the
        site's own event counter (the trainer passes the global step so
        rules are step-deterministic under retries and restarts)."""
        idx = self._next_index(site) if index is None else index
        for rule in self.rules:
            if rule.site != site or rule.action in ("truncate", "nan") \
                    or not rule.matches(idx):
                continue
            self._record(rule)
            if rule.action == "delay":
                time.sleep(rule.arg)
            elif rule.action == "crash":
                raise InjectedCrash(
                    f"injected crash at {site}[{idx}]")
            elif rule.action in ("kill", "sigterm"):
                # REAL process death, deterministically placed: SIGKILL
                # is uncatchable (the Python layer never sees it — the
                # supervisor must recover from a worker that left no
                # goodbye), SIGTERM runs the installed handlers (the
                # flight recorder dumps, then the default action kills)
                os.kill(os.getpid(), signal.SIGKILL
                        if rule.action == "kill" else signal.SIGTERM)
                # SIGTERM delivery can race the next bytecode; the sleep
                # makes the death site deterministic.  Surviving it
                # means another handler consumed the signal: fail loudly
                # rather than let the drill silently not happen.
                time.sleep(5.0)
                raise InjectedCrash(
                    f"injected {rule.action} at {site}[{idx}] did not "
                    f"kill the process (signal consumed); raising instead")
            else:
                raise InjectedFault(
                    f"injected {rule.action} at {site}[{idx}]")

    def poison(self, site: str, index: Optional[int] = None) -> bool:
        """True when a ``nan`` rule matches this site event — the
        instrumentation point then corrupts the value it was about to
        report (the trainer NaNs the step loss).  Separate from
        :meth:`fire` because poisoning must not raise and must not
        consume the site's shared event counter when an explicit index
        is in use."""
        rules = [r for r in self.rules
                 if r.site == site and r.action == "nan"]
        if not rules:
            return False
        idx = self._next_index(site + "#nan") if index is None else index
        for rule in rules:
            if rule.matches(idx):
                self._record(rule)
                return True
        return False

    def corrupt(self, site: str, path: str) -> bool:
        """Apply any matching ``truncate`` rule to a file the site just
        published (its own event counter, keyed ``site#truncate``).
        Returns True when the file was damaged."""
        rules = [r for r in self.rules
                 if r.site == site and r.action == "truncate"]
        if not rules:
            return False
        idx = self._next_index(site + "#truncate")
        for rule in rules:
            if not rule.matches(idx):
                continue
            size = os.path.getsize(path)
            keep = max(0, size - max(1, int(rule.arg or 64)))
            with open(path, "r+b") as f:
                f.truncate(keep)
            self._record(rule)
            return True
        return False


# ------------------------------------------------------------ global plan
_active: Optional[FaultPlan] = None


def install_fault_plan(plan: Optional[FaultPlan]) -> None:
    global _active
    _active = plan


def clear_fault_plan() -> None:
    install_fault_plan(None)


def get_fault_plan() -> Optional[FaultPlan]:
    return _active


@contextlib.contextmanager
def inject(plan_or_spec):
    """Scoped plan installation for tests:
    ``with faults.inject("trainer.step@7:crash"): ...``"""
    plan = (FaultPlan.parse(plan_or_spec)
            if isinstance(plan_or_spec, str) else plan_or_spec)
    prev = _active
    install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(prev)


def fire(site: str, index: Optional[int] = None) -> None:
    """Instrumentation entry point — a no-op when no plan is active."""
    plan = get_fault_plan()
    if plan is not None:
        plan.fire(site, index)


def corrupt(site: str, path: str) -> bool:
    plan = get_fault_plan()
    return plan.corrupt(site, path) if plan is not None else False


def poison(site: str, index: Optional[int] = None) -> bool:
    """Value-poisoning check — False when no plan is active."""
    plan = get_fault_plan()
    return plan.poison(site, index) if plan is not None else False
