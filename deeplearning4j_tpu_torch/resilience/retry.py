"""Retry, timeout and backoff: one policy for every flaky boundary (port
of ``deeplearning4j_tpu/resilience/retry.py``).

The DCN ring exchange and the local cluster's start-up use one reusable
policy in place of ad-hoc loops::

    peers = with_retries(lambda: transport.exchange(rank, msg),
                         policy=RetryPolicy(max_attempts=4, deadline_s=30.0),
                         site="dcn.exchange")

- exponential backoff (``base_delay_s * multiplier**(attempt-1)``, capped
  at ``max_delay_s``) with proportional jitter, deterministic per (site,
  attempt), so that workers desynchronize and tests stay exact;
- a **deadline**: when the next backoff would overrun ``deadline_s``
  since the first attempt, give up now rather than sleep past it;
- **classification**: only transient errors retry.  By default those are
  :class:`TransientError`, :class:`~deeplearning4j_tpu_torch.resilience.faults.InjectedFault`,
  timeouts, connection failures and transient OS errors; an
  :class:`~deeplearning4j_tpu_torch.resilience.faults.InjectedCrash` and
  everything else propagate on the first throw;
- observability: a ``retry_attempt`` span per attempt, the
  ``tpudl_resilience_{attempts,retries,giveups}_total`` counters and the
  ``tpudl_resilience_backoff_seconds`` histogram.
"""

from __future__ import annotations

import dataclasses
import errno
import time
import zlib
from typing import Any, Callable, Optional

from deeplearning4j_tpu_torch.obs import tracing
from deeplearning4j_tpu_torch.resilience.faults import InjectedCrash, InjectedFault


class TransientError(RuntimeError):
    """Marker for errors the raiser knows to be retryable."""


_TRANSIENT_ERRNOS = {errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT, errno.ECONNRESET,
                     errno.ECONNREFUSED, errno.ECONNABORTED, errno.EADDRINUSE, errno.EINTR,
                     errno.EPIPE}


def default_retryable(e: BaseException) -> bool:
    """Retry timeouts, connection trouble, transient OS errors, explicit
    markers and injected faults; never an injected crash (it stands in
    for process death)."""
    if isinstance(e, InjectedCrash):
        return False
    if isinstance(e, (TransientError, InjectedFault, TimeoutError, ConnectionError)):
        return True
    if isinstance(e, OSError):
        return e.errno in _TRANSIENT_ERRNOS
    return False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for :func:`with_retries`; frozen, so that one policy can be
    shared across threads (the DCN slice pools)."""

    max_attempts: int = 3
    deadline_s: Optional[float] = None     # wall budget across ALL attempts
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25                   # +[0, jitter) fraction of the delay
    retryable: Callable[[BaseException], bool] = default_retryable

    def delay_for(self, attempt: int, site: str = "") -> float:
        """Backoff before attempt ``attempt + 1`` (``attempt`` is the
        1-based attempt that just failed), its jitter a function of
        (site, attempt)."""
        base = min(self.max_delay_s, self.base_delay_s * self.multiplier ** (attempt - 1))
        if not self.jitter:
            return base
        u = (zlib.crc32(f"{site}:{attempt}".encode()) % 1000) / 1000.0
        return base * (1.0 + self.jitter * u)


def with_retries(fn: Callable[[], Any], *, policy: Optional[RetryPolicy] = None,
                 site: str = "call", sleep: Callable[[float], None] = time.sleep) -> Any:
    """``fn()`` under ``policy``: its value, or the last error once the
    attempts or the deadline run out or the error is not retryable.
    ``sleep`` is injectable so that tests read the backoff schedule
    without waiting it out."""
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    policy = policy or RetryPolicy()
    reg = get_registry()
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        reg.counter("tpudl_resilience_attempts_total").inc()
        with tracing.span("retry_attempt", site=site, attempt=attempt) as sp:
            try:
                return fn()
            except BaseException as e:
                sp.set_attribute("error", type(e).__name__)
                if not policy.retryable(e) or attempt >= policy.max_attempts:
                    reg.counter("tpudl_resilience_giveups_total").inc()
                    raise
                delay = policy.delay_for(attempt, site)
                if policy.deadline_s is not None and \
                        time.monotonic() - start + delay > policy.deadline_s:
                    reg.counter("tpudl_resilience_giveups_total").inc()
                    raise
        reg.counter("tpudl_resilience_retries_total").inc()
        reg.histogram("tpudl_resilience_backoff_seconds").observe(delay)
        sleep(delay)
