"""Durable checkpoints (port of the part of
``deeplearning4j_tpu/resilience/checkpoint.py`` that the ``io`` modules
need): atomic writes, sha256 manifests, verification, host snapshots of
a net and a background writer.

Every checkpoint zip goes through:

1. **atomic publication**: the bytes land in a temp file in the target's
   directory, are ``fsync``ed and ``os.replace``d over the target (the
   directory is fsynced too), so a reader sees the old file or the new
   one, never a torn one;
2. **a manifest**: ``manifest.json`` inside the zip maps every other
   entry to its sha256, so damage after publication is found entry by
   entry;
3. **verification on load**: :func:`verify_checkpoint` replays the zip's
   CRCs and the manifest's digests; loaders raise
   :class:`CheckpointCorruptError`, and discovery skips to the newest
   intact file.

:func:`snapshot_net` copies a net's training state to the host on the
caller's thread, at once: a captured step updates params and updater
state in place, so a copy made later would save a later step's values.
:class:`AsyncCheckpointer` then writes on a thread of its own.  A write
fires the ``checkpoint.write`` fault site and counts itself in
``tpudl_resilience_checkpoint_writes_total`` and
``tpudl_resilience_checkpoint_write_seconds``, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import queue
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Any, Callable, Mapping, Optional, Union

import torch

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification; ``problems`` lists every finding
    (truncation, a CRC failure, a digest mismatch, ...)."""

    def __init__(self, path: str, problems: list[str]):
        super().__init__(f"checkpoint {path} failed verification: " + "; ".join(problems))
        self.path = path
        self.problems = problems


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path: str):
    """Yield a temp path in ``path``'s directory; on a clean exit fsync it
    and ``os.replace`` it over ``path`` (then fsync the directory, so the
    rename itself is durable).  On an error the temp file is removed and
    the file already at ``path`` stays."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=os.path.basename(path) + ".tmp-")
    os.close(fd)
    try:
        yield tmp
        _fsync_path(tmp)
        os.replace(tmp, path)
        _fsync_path(directory)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_checkpoint_zip(path: str, entries: Mapping[str, Union[bytes, str, None]]) -> None:
    """``entries`` (None values left out) as a zip with a sha256 manifest,
    written atomically.  The entries are stored, not deflated: float
    weights barely compress (ResNet-50's by a few percent) and deflating
    them is the slowest part of a save; either package reads both.

    Fault sites: ``checkpoint.write`` fires inside the atomic region (an
    injected crash is a torn write: the published file survives intact),
    and its ``truncate`` rules damage the file after publication (disk
    corruption, for the verify path)."""
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    from deeplearning4j_tpu_torch.resilience import faults
    t0 = time.perf_counter()
    with atomic_write(path) as tmp:
        digests: dict[str, str] = {}
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            for name, data in entries.items():
                if data is None:
                    continue
                blob = data.encode() if isinstance(data, str) else data
                zf.writestr(name, blob)
                digests[name] = hashlib.sha256(blob).hexdigest()
            zf.writestr(MANIFEST_NAME, json.dumps(
                {"format": MANIFEST_FORMAT, "algorithm": "sha256", "entries": digests}))
        faults.fire("checkpoint.write")
    faults.corrupt("checkpoint.write", path)
    reg = get_registry()
    reg.counter("tpudl_resilience_checkpoint_writes_total").inc()
    reg.histogram("tpudl_resilience_checkpoint_write_seconds").observe(time.perf_counter() - t0)


def read_manifest(zf: zipfile.ZipFile) -> Optional[dict]:
    if MANIFEST_NAME not in zf.namelist():
        return None
    return json.loads(zf.read(MANIFEST_NAME).decode())


# the end-of-central-directory record: its signature and fixed size
_EOCD_SIGNATURE = b"PK\x05\x06"
_EOCD_SIZE = 22


def _ends_with_its_directory(path: str) -> bool:
    """Whether the last end-of-central-directory record of the file (with
    its comment) ends the file.  ``zipfile`` searches back from the end
    for one, so a stored zip cut short can open as the archive stored
    inside it (a params ``.npz`` is itself a zip) and pass as intact."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        f.seek(max(0, size - _EOCD_SIZE - 0xFFFF))
        tail = f.read()
    at = tail.rfind(_EOCD_SIGNATURE)
    if at < 0 or len(tail) - at < _EOCD_SIZE:
        return False
    comment = int.from_bytes(tail[at + 20:at + 22], "little")
    return at + _EOCD_SIZE + comment == len(tail)


def verify_checkpoint(path: str, require_manifest: bool = False) -> list[str]:
    """The findings of a checkpoint zip's check (empty: intact): a zip
    whose directory ends the file, readable, every entry's CRC, the
    manifest's presence and coverage, and each entry's sha256.  A zip
    without a manifest passes unless ``require_manifest``."""
    problems: list[str] = []
    if not os.path.exists(path):
        return [f"missing file {path}"]
    try:
        if not _ends_with_its_directory(path):
            return ["unreadable zip: no end-of-central-directory record at the end of the "
                    "file (truncated)"]
        with zipfile.ZipFile(path, "r") as zf:
            bad = zf.testzip()
            if bad is not None:
                return [f"CRC failure in entry {bad!r}"]
            try:
                manifest = read_manifest(zf)
            except (ValueError, json.JSONDecodeError) as e:
                return [f"unreadable manifest: {e}"]
            if manifest is None:
                if require_manifest:
                    problems.append("no manifest.json (pre-manifest format)")
                return problems
            declared = manifest.get("entries", {})
            present = set(zf.namelist()) - {MANIFEST_NAME}
            for name in sorted(set(declared) - present):
                problems.append(f"entry {name!r} in manifest but not in zip")
            for name in sorted(present - set(declared)):
                problems.append(f"entry {name!r} not covered by manifest")
            for name in sorted(set(declared) & present):
                if hashlib.sha256(zf.read(name)).hexdigest() != declared[name]:
                    problems.append(f"sha256 mismatch for entry {name!r}")
    except (zipfile.BadZipFile, OSError, ValueError, zlib.error) as e:
        # damage inside an entry's DEFLATE stream can surface as a
        # decompressor error before the CRC check: the same verdict
        return [f"unreadable zip: {e}"]
    return problems


def is_valid_checkpoint(path: str) -> bool:
    return not verify_checkpoint(path)


def _host_tree(tree):
    """Every tensor of a tree copied to the host (a copy even for a CPU
    tensor: ``.cpu()`` of one would alias it)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if torch.is_tensor(tree) else tree


class NetSnapshot:
    """A host copy of what a checkpoint of a net holds, with the
    attributes ``io.model_serializer.write_model`` reads, so that a
    background thread can write the zip while the net trains on."""

    def __init__(self, net):
        self.conf = net.conf
        self.params_ = _host_tree(net.params_)
        self.state_ = _host_tree(net.state_)
        self.opt_state = None if net.opt_state is None else _host_tree(net.opt_state)
        self.iteration = net.iteration
        self.epoch = net.epoch
        self.model_type = type(net).__name__
        self._score = getattr(net, "_score", float("nan"))
        # the resume bookkeeping the trainer stamps on the net
        for attr in ("_completed_iterations", "_completed_epochs", "_epoch_batches"):
            if hasattr(net, attr):
                setattr(self, attr, getattr(net, attr))
        stream = getattr(net, "_stream", None)
        self._stream_state = None if stream is None else stream.get_state()
        self._stream_device = None if stream is None else stream.device.type
        self.layers = net.layers        # what the updater state's layout is read from
        if hasattr(net, "_topo"):
            self._topo = net._topo


def snapshot_net(net) -> NetSnapshot:
    """A host copy of everything a checkpoint of ``net`` holds, made now on
    the caller's thread (the step updates the net's tensors in place);
    the disk work can then happen anywhere."""
    return NetSnapshot(net)


class AsyncCheckpointer:
    """One background thread draining a queue of save jobs.  A failed save
    is never dropped: it is raised again on the caller's thread by the
    next ``submit``, ``flush`` or ``close``."""

    _DONE = object()

    def __init__(self, name: str = "tpudl-checkpointer"):
        self._q: queue.Queue = queue.Queue()
        self._error_lock = threading.Lock()
        self._error: list[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is self._DONE:
                    return
                job()
            except BaseException as e:   # raised again on the caller's thread
                with self._error_lock:
                    self._error.append(e)
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._error_lock:
            error = self._error.pop(0) if self._error else None
        if error is not None:
            raise RuntimeError("background checkpoint save failed") from error

    def submit(self, job: Callable[[], Any]) -> None:
        self._raise_pending()
        if not self._thread.is_alive():
            raise RuntimeError("AsyncCheckpointer is closed")
        self._q.put(job)

    def flush(self) -> None:
        """Wait for every submitted save; raise the first failure, if any."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(self._DONE)
            self._thread.join(timeout=30.0)
        self._raise_pending()
