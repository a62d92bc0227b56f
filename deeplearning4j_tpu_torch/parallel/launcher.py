"""Local multi-process gangs (port of ``deeplearning4j_tpu/parallel/launcher.py``).

The reference's cluster story (Spark launches one long-lived worker per
executor; they find each other through a handshake) is, in one process
per host, :func:`initialize`: ``torch.distributed``'s process
group over gloo, whose address, world size and rank are arguments.

:func:`spawn_local_cluster` is the multi-process test rig (the
``DummyTransport`` translation): it starts N local processes over
loopback and runs a function in each under a real process group, on the
CPU or on a card.  Each child gets everything it needs in a pickled call
from the parent: its rank, the world size, the coordinator's port, its
device, its flight-recorder dump path and watchdog deadline, the
launcher's trace context, any environment the caller asks for, and its
:class:`ChildContext` (worker id, restart generation, resume pointer,
gang width, the grown flag, the telemetry endpoint, a fault plan), which
:func:`child_context` reads inside the child.  Nothing is read from the
parent's environment.  A child on a card loads the CUDA kernels that the
parent built before spawning it (one build, not N racing ones).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class ChildContext:
    """What a gang child knows of its gang beyond its rank: the JAX
    package hands each of these to a child in an environment variable,
    the port in the child's pickled call.

    - ``worker``: its stable worker id (``w<slot>``), across restarts;
    - ``generation``: the supervisor's restart generation (0 first);
    - ``resume_from``: the checkpoint directory a respawned child resumes
      from (set only when a verified checkpoint exists under it;
      ``Trainer.fit`` takes it when given no ``resume_from``);
    - ``gang_width``: the gang's current width
      (``resilience.elastic.configured_width``);
    - ``grown``: set only in the generation that a grow spawned
      (``Trainer.resume_state`` then fires the ``gang.grow`` site);
    - ``remote_ui``: the coordinator ``UIServer``'s URL, where the child's
      ``obs.remote`` router pushes;
    - ``fault_plan``: a ``resilience.faults`` spec the child installs
      first (the supervisor leaves it out of restarted generations)."""

    worker: Optional[str] = None
    generation: int = 0
    resume_from: Optional[str] = None
    gang_width: Optional[int] = None
    grown: bool = False
    remote_ui: Optional[str] = None
    fault_plan: Optional[str] = None


_CONTEXT = ChildContext()
_CONTEXT_FIELDS = frozenset(f.name for f in dataclasses.fields(ChildContext))


def child_context() -> ChildContext:
    """This process's :class:`ChildContext` (all defaults outside a gang)."""
    return _CONTEXT


def set_child_context(ctx: Optional[ChildContext]) -> ChildContext:
    """Install ``ctx`` (None: the defaults) as this process's context;
    returns the one it replaces.  A child's bootstrap calls it."""
    global _CONTEXT
    prev, _CONTEXT = _CONTEXT, ctx or ChildContext()
    return prev


def context_fields(values: dict) -> dict:
    """``values`` checked as :class:`ChildContext` fields (plain values,
    for a pickled call); an unknown name raises ``ValueError``."""
    unknown = set(values) - _CONTEXT_FIELDS
    if unknown:
        raise ValueError(f"unknown child context fields {sorted(unknown)} (have "
                         f"{sorted(_CONTEXT_FIELDS)})")
    return dict(values)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, timeout_s: float = 120.0) -> None:
    """``torch.distributed.init_process_group`` (gloo) for ``num_processes``
    processes, this one ``process_id``, meeting at ``coordinator_address``
    (``"host:port"`` or ``"tcp://host:port"``); the port reads no
    environment for these.  Nothing to do for one process (or none
    given)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.obs import tracing
    if not num_processes or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize needs coordinator_address and process_id for "
                         f"{num_processes} processes")
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    with tracing.span("distributed_init", processes=num_processes, process_id=process_id):
        dist.init_process_group("gloo", init_method=address, world_size=num_processes,
                                rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))


# The child's bootstrap.  Its one argument is the path of its pickled call
# (a dict of plain values); the caller's function is unpickled after the
# search path, the environment it asked for, the child context (its fault
# plan and telemetry router), the black box and the process group are set
# up.  The router drains before the child exits.
_WORKER_TEMPLATE = r"""
import os, pickle, sys
with open(sys.argv[1], "rb") as f:
    call = pickle.load(f)
sys.path[:0] = call["path"]
os.environ.update(call["env"])
import torch
from deeplearning4j_tpu_torch import config
from deeplearning4j_tpu_torch.obs import flight_recorder, remote, tracing
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.resilience import faults
ctx = launcher.ChildContext(**call["context"])
launcher.set_child_context(ctx)
if ctx.fault_plan:
    faults.install_fault_plan(faults.FaultPlan.parse(ctx.fault_plan))
remote.install_from_context()
flight_recorder.install_handlers(call["dump"])
if call["tracing"]:
    config.set_config(tracing=True)
if call["trace_parent"]:
    tracing.get_tracer().set_remote_parent(tracing.extract(call["trace_parent"]))
if call["deadline"]:
    flight_recorder.start_watchdog(call["deadline"], dump_path=call["dump"],
                                   exit_code=flight_recorder.WATCHDOG_EXIT_CODE,
                                   fires_before_exit=call["fires"])
device = None if call["device"] is None else torch.device(call["device"])
if device is not None and device.type == "cuda" and device.index is not None:
    torch.cuda.set_device(device)
launcher.initialize(f"127.0.0.1:{call['port']}", call["world"], call["rank"],
                    timeout_s=call["timeout"])
with open(call["fn"], "rb") as f:
    fn = pickle.load(f)
try:
    result = fn(call["rank"], call["world"])
    with open(call["out"], "wb") as f:
        pickle.dump(result, f)
finally:
    flight_recorder.stop_watchdog()
    remote.close_router(timeout=5.0)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
"""


class ClusterTimeoutError(RuntimeError):
    """The gang did not finish within the wall budget.  NOT retryable:
    its message holds every child's stderr tail, whose join noise
    ("connection refused") must not pass for a start-up flake, and a
    rerun would spend the timeout again.  ``flight_dumps`` maps process
    id → that child's parsed flight-recorder dump lines."""

    def __init__(self, *args):
        super().__init__(*args)
        self.flight_dumps: dict = {}


class ClusterStallError(RuntimeError):
    """One or more gang members' flight-recorder watchdogs fired (no step
    or exchange progress within the gang deadline); the black boxes are
    attached as ``flight_dumps``.  NOT retryable: a deterministic stall
    would stall again."""

    def __init__(self, *args):
        super().__init__(*args)
        self.flight_dumps: dict = {}


# stderr fingerprints of a flaky START-UP (a stale coordinator port,
# racing binds), worth a retry on a fresh port; not "connection refused":
# when one child dies for a real reason its siblings print that too
_STARTUP_FLAKE_MARKERS = ("address already in use", "failed to bind", "errno 98")


def _is_startup_flake(e: BaseException) -> bool:
    from deeplearning4j_tpu_torch.resilience.retry import default_retryable
    if isinstance(e, (ClusterTimeoutError, ClusterStallError)):
        return False
    if default_retryable(e):
        return True
    msg = str(e).lower()
    return isinstance(e, RuntimeError) and any(m in msg for m in _STARTUP_FLAKE_MARKERS)


def _terminate_then_kill(procs, grace: float = 3.0, first_pid: int = 0,
                         tail_fn=None) -> list[str]:
    """Stop every child (TERM, a grace period, then KILL) and return each
    one's stderr tail: a timed-out gang leaves no orphans and no silent
    diagnostics.  ``tail_fn(pid) -> str`` gives the tail when the
    children write to files (GangHandle) instead of pipes."""
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    deadline = time.monotonic() + grace
    for proc in procs:
        if proc.poll() is None:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
    tails = []
    for pid, proc in enumerate(procs):
        if tail_fn is not None:
            try:
                proc.wait(timeout=5.0)
            except (subprocess.TimeoutExpired, ValueError, OSError):
                pass
            text = tail_fn(first_pid + pid)
        else:
            try:
                _, stderr = proc.communicate(timeout=5.0)
            except (subprocess.TimeoutExpired, ValueError, OSError):
                stderr = b""
            text = (stderr or b"").decode(errors="replace")
        tails.append(f"process {first_pid + pid} rc={proc.poll()} stderr tail: {text[-800:]}")
    return tails


def _collect_flight_dumps(workdir: str, n_processes: int) -> dict:
    """pid → parsed flight-recorder dump lines of every child that wrote one."""
    from deeplearning4j_tpu_torch.obs import flight_recorder
    dumps = {}
    for pid in range(n_processes):
        lines = flight_recorder.read_dump(os.path.join(workdir, f"flight_{pid}.jsonl"))
        if lines:
            dumps[pid] = lines
    return dumps


def _dump_summary(dumps: dict) -> str:
    """One line per dumped child for the raised error's message (the
    parsed dumps ride on its ``flight_dumps``)."""
    if not dumps:
        return "no flight-recorder dumps found"
    lines = []
    for pid, entries in sorted(dumps.items()):
        header = next((e for e in entries if e.get("type") == "header"), {})
        live = next((e for e in entries if e.get("type") == "liveness"), {})
        threads = sum(1 for e in entries if e.get("type") == "thread")
        events = sum(1 for e in entries if e.get("type") == "event")
        lines.append(f"process {pid} black box: reason={header.get('reason')} "
                     f"last_site={live.get('last_site')} "
                     f"stalled_for_s={live.get('stalled_for_s')} "
                     f"({threads} thread stacks, {events} ring events)")
    return "\n".join(lines)


def _device_of(device, pid: int):
    if device is None or isinstance(device, str):
        return device
    if isinstance(device, (list, tuple)):
        return None if device[pid] is None else str(device[pid])
    return str(device)


class GangHandle:
    """A RUNNING local gang.  Construction starts the children and
    returns; callers block in :meth:`wait` (``spawn_local_cluster``) or
    poll :meth:`poll_exits`, then :meth:`shutdown` the survivors and
    :meth:`collect_flight_dumps`.

    ``device`` is each child's device: one for all (``"cuda:0"``: every
    child shares the card) or one per process; None leaves the children
    on the CPU.  ``remote_ui`` (a coordinator ``UIServer``'s URL) makes
    every child push its telemetry there as worker ``w<pid>``;
    ``child_env`` is the per-child hook, ``pid -> dict`` of
    :class:`ChildContext` fields, applied last, so that a supervisor
    stamps each child's worker id, generation, resume pointer and fault
    plan over the defaults."""

    def __init__(self, fn: Callable, n_processes: int, port: int,
                 device: Union[None, str, Sequence] = None, timeout: float = 120.0,
                 extra_env: Optional[dict] = None, gang_deadline: Optional[float] = None,
                 gang_fires: int = 1, remote_ui: Optional[str] = None,
                 child_env: Optional[Callable[[int], dict]] = None):
        from deeplearning4j_tpu_torch.obs import tracing
        from deeplearning4j_tpu_torch.resilience import faults
        faults.fire("launcher.spawn")
        self.n_processes = n_processes
        self.timeout = timeout
        self.gang_deadline = gang_deadline
        self.workdir = tempfile.mkdtemp(prefix="dl4j_torch_cluster_")
        fn_path = os.path.join(self.workdir, "fn.pkl")
        with open(fn_path, "wb") as f:
            pickle.dump(fn, f)
        self.procs: list = []
        self.out_paths: list[str] = []
        trace_parent = tracing.inject()
        for pid in range(n_processes):
            out_path = os.path.join(self.workdir, f"out_{pid}.pkl")
            self.out_paths.append(out_path)
            context = {"worker": f"w{pid}", "remote_ui": remote_ui} if remote_ui else {}
            if child_env is not None:
                context.update(context_fields(child_env(pid)))
            call = {"path": [p for p in sys.path if p],
                    "env": {k: str(v) for k, v in (extra_env or {}).items()}, "fn": fn_path,
                    "out": out_path, "rank": pid, "world": n_processes, "port": port,
                    "device": _device_of(device, pid), "timeout": float(timeout),
                    # every child gets a black box: dumps on a crash or a
                    # SIGTERM always, a stall watchdog with a gang deadline
                    # (tracing on beside it, so the ring holds the spans)
                    "dump": os.path.join(self.workdir, f"flight_{pid}.jsonl"),
                    "deadline": None if gang_deadline is None else float(gang_deadline),
                    "fires": int(gang_fires), "tracing": gang_deadline is not None,
                    "trace_parent": trace_parent, "context": context}
            call_path = os.path.join(self.workdir, f"call_{pid}.pkl")
            with open(call_path, "wb") as f:
                pickle.dump(call, f)
            # children write to FILES, not pipes: a pipe nobody drains
            # would wedge a chatty child on a full buffer
            with open(os.path.join(self.workdir, f"stderr_{pid}.log"), "wb") as err_f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _WORKER_TEMPLATE, call_path],
                    stdout=err_f, stderr=err_f))
        # ONE wall-clock budget for the whole gang
        self.started_at = time.monotonic()
        self.deadline = self.started_at + timeout

    # ------------------------------------------------- supervision surface
    def poll_exits(self) -> dict:
        """pid → return code of every child (None: still running)."""
        return {pid: proc.poll() for pid, proc in enumerate(self.procs)}

    def running(self) -> bool:
        return any(proc.poll() is None for proc in self.procs)

    def stderr_tail(self, pid: int, limit: int = 800) -> str:
        """The last ``limit`` characters of the child's output file."""
        try:
            with open(os.path.join(self.workdir, f"stderr_{pid}.log"), "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 4 * limit))
                return f.read().decode(errors="replace")[-limit:]
        except OSError:
            return ""

    def request_dumps(self, grace: float = 3.0) -> None:
        """Ask every live child for its black box (SIGUSR1: the flight
        recorder dumps and the child lives on), then wait up to ``grace``
        for the dump files to grow past their size before the signal and
        go quiet."""
        def sizes():
            out = {}
            for pid in range(len(self.procs)):
                try:
                    out[pid] = os.path.getsize(os.path.join(self.workdir, f"flight_{pid}.jsonl"))
                except OSError:
                    out[pid] = -1
            return out

        before = sizes()
        alive = []
        for pid, p in enumerate(self.procs):
            if p.poll() is None:
                alive.append(pid)
                try:
                    p.send_signal(signal.SIGUSR1)
                except (ProcessLookupError, OSError):
                    pass
        if not alive:
            return
        deadline = time.monotonic() + grace
        prev = before
        while time.monotonic() < deadline:
            time.sleep(0.1)
            now = sizes()
            grown = all(now[pid] > before[pid] for pid in alive if self.procs[pid].poll() is None)
            settled = all(now[pid] == prev[pid] for pid in alive)
            if grown and settled:
                return
            prev = now

    def shutdown(self, grace: float = 3.0) -> list[str]:
        """Terminate, then kill, every remaining child; returns each one's
        stderr tail."""
        return _terminate_then_kill(self.procs, grace=grace, tail_fn=self.stderr_tail)

    def abort_timeout(self, reason: str, extra_lines: Optional[list] = None
                      ) -> "ClusterTimeoutError":
        """Stop the gang and build the ``ClusterTimeoutError`` of a blown
        wall budget."""
        tails = self.shutdown()
        dumps = self.collect_flight_dumps()
        err = ClusterTimeoutError(reason + "\n" + "\n".join((extra_lines or []) + tails)
                                  + "\n" + _dump_summary(dumps))
        err.flight_dumps = dumps
        return err

    def collect_flight_dumps(self) -> dict:
        return _collect_flight_dumps(self.workdir, self.n_processes)

    def results(self) -> list:
        """The return values of the children that completed."""
        results = []
        for path in self.out_paths:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results.append(pickle.load(f))
        return results

    # ----------------------------------------------- blocking collection
    def wait(self) -> list:
        """Block until the gang finishes; return every child's result or
        raise (``ClusterTimeoutError``, ``ClusterStallError`` or
        ``RuntimeError``) with the flight dumps attached."""
        from deeplearning4j_tpu_torch.obs import flight_recorder
        results, errors, stalled = [], [], []
        for pid, proc in enumerate(self.procs):
            try:
                proc.wait(timeout=max(0.1, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise self.abort_timeout(
                    f"local cluster timed out after {self.timeout:.0f}s waiting for process "
                    f"{pid}; all {self.n_processes} children stopped:", extra_lines=stalled)
            if proc.returncode == flight_recorder.WATCHDOG_EXIT_CODE:
                stalled.append(f"process {pid} stalled (flight-recorder watchdog, gang "
                               f"deadline {self.gang_deadline}s): "
                               f"{self.stderr_tail(pid, limit=400)}")
                # one stalled member wedges its siblings on the same
                # exchange, whose watchdogs fire within a poll: give each
                # live sibling a short window to write its black box, then
                # stop the rest
                rest = self.procs[pid + 1:]
                if rest:
                    grace_deadline = time.monotonic() + min(5.0, self.gang_deadline or 5.0)
                    while time.monotonic() < grace_deadline and any(
                            p.poll() is None and not os.path.exists(
                                os.path.join(self.workdir, f"flight_{q}.jsonl"))
                            for q, p in enumerate(rest, start=pid + 1)):
                        time.sleep(0.05)
                    time.sleep(0.2)     # let an in-flight dump finish
                    errors.extend(f"stopped after sibling stall: {tail}"
                                  for tail in _terminate_then_kill(
                                      rest, first_pid=pid + 1, tail_fn=self.stderr_tail))
                break
            elif proc.returncode != 0:
                errors.append(f"process {pid} rc={proc.returncode}: {self.stderr_tail(pid)}")
            elif os.path.exists(self.out_paths[pid]):
                with open(self.out_paths[pid], "rb") as f:
                    results.append(pickle.load(f))
        if stalled:
            dumps = self.collect_flight_dumps()
            err = ClusterStallError("local cluster stalled:\n" + "\n".join(stalled + errors)
                                    + "\n" + _dump_summary(dumps))
            err.flight_dumps = dumps
            raise err
        if errors:
            err = RuntimeError("local cluster failed:\n" + "\n".join(errors))
            err.flight_dumps = self.collect_flight_dumps()
            raise err
        return results


def prepare_devices(device: Union[None, str, Sequence]) -> None:
    """Before children start on a card: check it is there (``device``
    as ``GangHandle`` takes it) and build the CUDA kernels once, in this
    process, for the children to load."""
    import torch
    devices = device if isinstance(device, (list, tuple)) else [device]
    if any(d is not None and torch.device(d).type == "cuda" for d in devices):
        from deeplearning4j_tpu_torch.config import resolve_device
        from deeplearning4j_tpu_torch.ops.kernels import _build
        for d in devices:
            if d is not None:
                resolve_device(d)
        _build.build()


def spawn_local_cluster(fn: Callable, n_processes: int = 2, port: int = 12655,
                        device: Union[None, str, Sequence] = None, timeout: float = 120.0,
                        extra_env: Optional[dict] = None, startup_retries: int = 2,
                        gang_deadline: Optional[float] = None,
                        remote_ui: Optional[str] = None) -> list:
    """Run ``fn(process_index, process_count)`` in N fresh local processes
    under a ``torch.distributed`` process group (gloo, loopback); returns
    each process's pickled return value.  ``fn`` must be picklable (a
    module-level function, or a ``functools.partial`` of one).

    ``device`` puts the children on a card (``"cuda"``, ``"cuda:0"``: all
    of them share it; or one device per process); the parent builds the
    CUDA kernels first.  A child that never finishes gets the WHOLE gang
    terminated, then killed, and the error carries every child's stderr
    tail; start-up flakes (a stale coordinator port, racing binds) retry
    up to ``startup_retries`` times on a shifted port with backoff
    (``resilience.retry``, site ``launcher.spawn``).

    Every child dumps a black box (thread stacks, the last events and
    spans, a metrics snapshot) on a crash or SIGTERM.  ``gang_deadline``
    arms a stall watchdog in each child: one whose instrumented sites
    (``trainer.step``, ``dcn.exchange``, ...) make no progress for that
    long dumps and exits, and the raised :class:`ClusterStallError` or
    :class:`ClusterTimeoutError` carries every child's parsed dump as
    ``flight_dumps``.  Without one, the deadline is half the wall budget
    with one grace fire; ``gang_deadline=0`` disables the watchdog.  The
    watchdog arms on a child's FIRST progress stamp.

    When tracing is on in the parent, its span context goes to every
    child, so the children's spans parent under the launcher's.
    ``remote_ui`` (a coordinator ``UIServer``'s URL) federates the gang's
    telemetry: every child pushes its steps and heartbeats there as worker
    ``w<pid>`` (``obs.remote``)."""
    from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, with_retries
    prepare_devices(device)
    gang_fires = 1
    if gang_deadline is None:
        # half the wall budget with ONE grace fire, so that a slow start
        # (a capture, a first call) costs a spurious dump, not the gang; a
        # real stall still exits at twice the deadline, inside the budget
        gang_deadline = max(5.0, (timeout - 15.0) / 2.0)
        gang_fires = 2
    elif gang_deadline <= 0:
        gang_deadline = None
    attempt = {"n": 0}

    def _once():
        i = attempt["n"]
        attempt["n"] += 1
        # a fresh port per retry: the usual flake is the last gang's
        # coordinator socket lingering in TIME_WAIT
        return GangHandle(fn, n_processes, port + i * 97, device=device, timeout=timeout,
                          extra_env=extra_env, gang_deadline=gang_deadline,
                          gang_fires=gang_fires, remote_ui=remote_ui).wait()

    policy = RetryPolicy(max_attempts=1 + max(0, startup_retries), base_delay_s=0.2, jitter=0.0,
                         retryable=_is_startup_flake)
    return with_retries(_once, policy=policy, site="launcher.spawn")
