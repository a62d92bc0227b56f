"""Flight recorder: every failure leaves a black box (port of
``deeplearning4j_tpu/obs/flight_recorder.py``).

A bounded in-process ring buffer of recent events (steps, serve
dispatches, finished spans, notes), plus a watchdog thread and dump
triggers, so a hang or crash leaves a JSONL report instead of silence.

- :func:`record` appends an event to the ring (deque, O(1));
  :func:`progress` additionally stamps a liveness site for the watchdog.
- :func:`dump` writes the black box: a header (reason, pid, host), a
  stack trace of EVERY live thread, the ring's recent events, a
  snapshot of the metrics registry, a cost-model section (the port has
  no cost model yet, and the section says so) and the card's state, one
  JSON object per line, appended to a per-process file.  The JAX
  package's :func:`read_dump` reads it, and this one reads its dumps.
- :class:`Watchdog` fires when NO instrumented site has made progress
  within ``deadline_s``.  It arms on the *first* progress stamp, so a
  process that never touches an instrumented site is never killed by
  it.  On fire it dumps, prints the stall report to stderr, and
  optionally ``os._exit``\\ s with :data:`WATCHDOG_EXIT_CODE`.
- :func:`install_handlers` chains dumps onto ``sys.excepthook``,
  ``threading.excepthook`` and ``SIGTERM``.

The dump path is an argument, else a file under ``config.trace_dir``;
nothing here reads the environment.  The ring records regardless of
tracing; when tracing is ON, finished spans are mirrored into the ring
too (span hook registered at import), so a dump carries the last N spans
with durations, device-sync times and attributes.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Optional

WATCHDOG_EXIT_CODE = 87      # distinct from rc=124 (harness) / rc=1 (error)

RING_CAPACITY = 512
SPAN_ATTR_LIMIT = 8          # attrs kept per mirrored span event


class FlightRecorder:
    """Bounded ring of recent events + liveness stamps + dump writer."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        # reentrant: the SIGTERM/excepthook dump runs on the main thread
        # and must not deadlock when the signal lands while that same
        # thread is inside record()/progress() holding this lock
        self._lock = threading.RLock()
        self._progress: dict[str, float] = {}     # site → monotonic stamp
        self._progress_count = 0

    # ------------------------------------------------------------ events
    def record(self, kind: str, **data: Any) -> None:
        event = {"t": time.time(), "mono": time.monotonic(), "kind": kind}
        event.update(data)
        with self._lock:
            self._ring.append(event)

    def progress(self, site: str, **data: Any) -> None:
        """Liveness stamp: the watchdog considers the process healthy as
        long as SOME site keeps stamping.  Data-carrying stamps also
        land in the ring as ``progress`` events; bare stamps only touch
        the liveness table (hot-path sites stamp every step — echoing
        each one into the ring would halve the useful event history)."""
        now = time.monotonic()
        with self._lock:
            self._progress[site] = now
            self._progress_count += 1
        if data:
            self.record("progress", site=site, **data)

    def events(self, last_n: Optional[int] = None) -> list[dict]:
        with self._lock:
            items = list(self._ring)
        return items if last_n is None else items[-last_n:]

    def last_progress(self) -> tuple[Optional[str], Optional[float], int]:
        """(most recent site, its monotonic stamp, total stamps)."""
        with self._lock:
            if not self._progress:
                return None, None, self._progress_count
            site = max(self._progress, key=self._progress.get)
            return site, self._progress[site], self._progress_count

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._progress.clear()
            self._progress_count = 0

    # -------------------------------------------------------------- dump
    def _thread_stacks(self) -> list[dict]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            out.append({
                "type": "thread", "tid": ident,
                "name": names.get(ident, "?"),
                "stack": traceback.format_stack(frame),
            })
        return out

    def _metrics_snapshot(self) -> dict:
        try:
            from deeplearning4j_tpu_torch.obs.registry import get_registry
            reg = get_registry()
            return {name: getattr(reg.get(name), "value",
                                  getattr(reg.get(name), "count", None))
                    for name in reg.names()}
        except Exception as e:
            return {"error": repr(e)}

    def _device_state(self) -> dict:
        """Best-effort facts of the card.  Touches torch.cuda only if it
        is already initialized, so a dump never initializes the card."""
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return {"note": "cuda not initialized"}
        try:
            dev = torch.cuda.current_device()
            out = {"n_local_devices": torch.cuda.device_count(),
                   "platform": "gpu",
                   "device_kind": torch.cuda.get_device_name(dev)}
            stats = torch.cuda.memory_stats(dev)
            if stats:
                out["memory_stats"] = {k: int(v) for k, v in stats.items()
                                       if isinstance(v, (int, float))}
            return out
        except Exception as e:
            return {"error": repr(e)}

    def dump(self, path: Optional[str] = None, reason: str = "explicit",
             last_n: Optional[int] = None, detail: Optional[dict] = None
             ) -> str:
        """Write one black-box block (JSONL) and return the path.  Never
        raises — a failing dump prints to stderr and returns the path it
        tried."""
        path = path or default_dump_path()
        lines: list[dict] = [{
            "type": "header", "reason": reason, "time": time.time(),
            "pid": os.getpid(), "host": socket.gethostname(),
            "argv": sys.argv[:4], "detail": detail or {},
        }]
        site, stamp, count = self.last_progress()
        lines.append({"type": "liveness", "last_site": site,
                      "stalled_for_s": (None if stamp is None else
                                        round(time.monotonic() - stamp, 3)),
                      "progress_stamps": count})
        lines.extend(self._thread_stacks())
        for event in self.events(last_n):
            lines.append({"type": "event", **event})
        lines.append({"type": "metrics", "values": self._metrics_snapshot()})
        lines.append({"type": "cost_breakdown", "top_programs": [],
                      "note": "no cost model in this package"})
        lines.append({"type": "device", **self._device_state()})
        try:
            directory = os.path.dirname(path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            with open(path, "a") as f:
                for line in lines:
                    f.write(json.dumps(line, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            print(f"flight-recorder: dump to {path} failed: {e}",
                  file=sys.stderr)
        return path


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **data: Any) -> None:
    _recorder.record(kind, **data)


def progress(site: str, **data: Any) -> None:
    _recorder.progress(site, **data)


def dump(path: Optional[str] = None, reason: str = "explicit",
         **kw: Any) -> str:
    return _recorder.dump(path, reason=reason, **kw)


def default_dump_path() -> str:
    """Per-process dump file under ``config.trace_dir``."""
    from deeplearning4j_tpu_torch.config import get_config
    return os.path.join(get_config().trace_dir,
                        f"flight_{socket.gethostname()}_{os.getpid()}.jsonl")


# ------------------------------------------------------------- span hook
def _span_finished(span) -> None:
    attrs = dict(list(span.attributes.items())[:SPAN_ATTR_LIMIT])
    _recorder.record("span", name=span.name,
                     duration_ms=round(span.duration_s * 1e3, 3),
                     device_sync_ms=round(span.device_sync_s * 1e3, 3),
                     trace_id=span.trace_id, span_id=span.span_id,
                     attributes={k: (v if isinstance(v, (int, float, str,
                                                         bool, type(None)))
                                     else str(v)) for k, v in attrs.items()})


def _register_span_hook() -> None:
    from deeplearning4j_tpu_torch.obs import tracing
    tracing.add_span_hook(_span_finished)


_register_span_hook()


# -------------------------------------------------------------- watchdog
class Watchdog:
    """Fires once when no progress stamp lands within ``deadline_s``.

    ``arm_on_first_progress`` (the default) starts the clock
    at the first stamp, so uninstrumented workloads are never killed;
    ``arm_on_first_progress=False`` starts it immediately (a process
    that never reaches its first step is itself a stall).

    ``fires_before_exit`` > 1 gives slow-but-alive phases grace: each
    fire short of the threshold dumps + reports and RE-ARMS (the fire
    counts as a synthetic stamp), and any real progress resets the
    count — only ``fires_before_exit`` consecutive dead deadlines
    ``os._exit``.  A legitimately long build or capture between stamps then
    costs a spurious dump, not the process."""

    def __init__(self, deadline_s: float,
                 recorder: Optional[FlightRecorder] = None,
                 dump_path: Optional[str] = None,
                 on_fire: Optional[Callable[[dict], None]] = None,
                 exit_code: Optional[int] = None,
                 arm_on_first_progress: bool = True,
                 poll_s: Optional[float] = None,
                 fires_before_exit: int = 1,
                 exit_grace_s: Optional[float] = None):
        self.deadline_s = float(deadline_s)
        self.recorder = recorder or _recorder
        self.dump_path = dump_path
        self.on_fire = on_fire
        self.exit_code = exit_code
        self.arm_on_first_progress = arm_on_first_progress
        self.poll_s = poll_s or max(0.2, min(2.0, self.deadline_s / 5.0))
        self.fires_before_exit = max(1, int(fires_before_exit))
        # processes of one job stall on the same collective, so sibling
        # watchdogs fire within ~one poll interval of each other, and one
        # process's exit can abort the others before their dumps land.
        # Hold the exit one grace window so every stalled sibling writes
        # its black box first.
        self.exit_grace_s = (self.poll_s + 0.5 if exit_grace_s is None
                             else max(0.0, float(exit_grace_s)))
        self.fired = threading.Event()
        self._stop = threading.Event()
        self._t0 = time.monotonic()
        self._fire_count = 0
        self._last_fire = None          # monotonic time of last fire
        self._last_stamp_seen = None    # progress stamp at last fire
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpudl-flight-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            site, stamp, count = self.recorder.last_progress()
            if stamp is None:
                if self.arm_on_first_progress:
                    continue            # not armed yet
                stamp = self._t0        # armed since construction
            if stamp != self._last_stamp_seen and self._last_stamp_seen \
                    is not None:
                self._fire_count = 0    # real progress since last fire
            baseline = stamp if self._last_fire is None \
                else max(stamp, self._last_fire)
            stalled = time.monotonic() - baseline
            if stalled >= self.deadline_s:
                self._fire(site, time.monotonic() - stamp, stamp)
                if self._fire_count >= self.fires_before_exit:
                    return

    def _fire(self, site: Optional[str], stalled_s: float,
              stamp: Optional[float]) -> None:
        self.fired.set()
        self._fire_count += 1
        self._last_fire = time.monotonic()
        self._last_stamp_seen = stamp
        final = self._fire_count >= self.fires_before_exit
        facts = {"stalled_site": site, "stalled_for_s": round(stalled_s, 3),
                 "deadline_s": self.deadline_s,
                 "fire": self._fire_count,
                 "fires_before_exit": self.fires_before_exit}
        self.recorder.record("watchdog_fired", **facts)
        path = self.recorder.dump(self.dump_path, reason="watchdog",
                                  detail=facts)
        print(f"flight-recorder watchdog: no progress for "
              f"{stalled_s:.1f}s (deadline {self.deadline_s:.1f}s, last "
              f"site {site!r}, fire {self._fire_count}/"
              f"{self.fires_before_exit}) — black box dumped to {path}",
              file=sys.stderr, flush=True)
        if self.on_fire is not None:
            try:
                self.on_fire(facts)
            except Exception:
                pass
        if final and self.exit_code is not None:
            # a gang member must DIE visibly, not linger: the parent
            # then collects this child's dump instead of timing out —
            # but not before sibling watchdogs (firing within ~poll_s of
            # this one) have written THEIR dumps; this exit tears down
            # the coordination service and aborts them mid-flight
            if self.exit_grace_s > 0:
                time.sleep(self.exit_grace_s)
            # the grace window can race a clean shutdown (stop() from a
            # finishing main thread) or late real progress (the slow
            # phase completed just past the deadline) — a process that
            # is demonstrably alive must not be reported as a stall
            if self._stop.is_set():
                return
            _, stamp_now, _ = self.recorder.last_progress()
            if stamp_now is not None and stamp_now != stamp:
                self._fire_count = 0    # late progress: re-arm
                return
            os._exit(self.exit_code)


_watchdog: Optional[Watchdog] = None


def start_watchdog(deadline_s: float, **kw: Any) -> Watchdog:
    """Start (or replace) the process watchdog."""
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
    _watchdog = Watchdog(deadline_s, **kw)
    return _watchdog


def stop_watchdog() -> None:
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


# ------------------------------------------------------- crash triggers
_handlers_installed = False


def install_handlers(dump_path: Optional[str] = None) -> None:
    """Chain black-box dumps onto unhandled exceptions (main + worker
    threads) and SIGTERM.  Idempotent; previous hooks keep running."""
    global _handlers_installed
    if _handlers_installed:
        return
    _handlers_installed = True

    prev_except = sys.excepthook

    def _excepthook(exc_type, exc, tb):
        _recorder.record("unhandled_exception", error=repr(exc))
        _recorder.dump(dump_path, reason="unhandled_exception",
                       detail={"error": repr(exc)})
        prev_except(exc_type, exc, tb)

    sys.excepthook = _excepthook

    prev_thread = threading.excepthook

    def _thread_hook(args):
        _recorder.record("thread_exception", error=repr(args.exc_value),
                         thread=getattr(args.thread, "name", "?"))
        _recorder.dump(dump_path, reason="thread_exception",
                       detail={"error": repr(args.exc_value)})
        prev_thread(args)

    threading.excepthook = _thread_hook

    if threading.current_thread() is threading.main_thread():
        # dump-request signal: SIGUSR1 dumps the black box WITHOUT dying,
        # so "dump, then terminate" can be two separate signals where
        # another handler owns SIGTERM: USR1 collects the evidence,
        # TERM/KILL stops the process.
        try:
            def _on_usr1(signum, frame):
                _recorder.record("dump_request")
                _recorder.dump(dump_path, reason="dump_request")

            signal.signal(signal.SIGUSR1, _on_usr1)
        except (ValueError, OSError, AttributeError):
            pass    # non-main thread / restricted env / no SIGUSR1
        try:
            prev_term = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                _recorder.record("sigterm")
                _recorder.dump(dump_path, reason="sigterm")
                if callable(prev_term):
                    prev_term(signum, frame)
                elif prev_term is signal.SIG_IGN:
                    return      # was deliberately ignored: dump, survive
                else:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            pass    # non-main interpreter thread / restricted env


def read_dump(path: str) -> list[dict]:
    """Parse a dump file back into its JSON lines (tolerant of trailing
    partial lines from a killed writer)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out
