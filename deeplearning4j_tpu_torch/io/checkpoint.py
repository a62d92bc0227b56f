"""CheckpointListener: periodic durable checkpoints with keep-last-K (port
of ``deeplearning4j_tpu/io/checkpoint.py``, DL4J's
``CheckpointListener.java``).

Save every N iterations, N epochs or N seconds; keep the last K (or
all); find the newest for a resume:

- every checkpoint zip is written atomically with a sha256 manifest
  (``io.model_serializer.write_model``, ``resilience.checkpoint``);
- the ``checkpoints.json`` index is written atomically too, and rebuilt
  from a scan of the directory on start, so a restarted process goes on
  pruning the previous run's checkpoints;
- :meth:`CheckpointListener.last_checkpoint_in` verifies each candidate
  and falls back to the newest intact zip;
- ``background=True`` copies the net to the host on the listener's
  thread (``snapshot_net``: the step updates the net's tensors in place)
  and serializes, zips and fsyncs on a save thread of its own;
  ``flush()`` and ``close()`` wait for it and raise a failed save.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.obs.listeners import TrainingListener
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    AsyncCheckpointer, atomic_write, is_valid_checkpoint, snapshot_net)

_CHECKPOINT_RE = re.compile(r"^checkpoint_iter(\d+)_epoch(\d+)\.zip$")
INDEX_NAME = "checkpoints.json"


def _scan_checkpoints(directory: str) -> list[str]:
    """The checkpoints in ``directory``, oldest to newest by the
    (iteration, epoch) of their names."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    found = []
    for name in names:
        m = _CHECKPOINT_RE.match(name)
        if m:
            found.append((int(m.group(1)), int(m.group(2)), os.path.join(directory, name)))
    return [path for _, _, path in sorted(found)]


class CheckpointListener(TrainingListener):
    def __init__(self, directory: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 save_every_seconds: Optional[float] = None,
                 keep_last: Optional[int] = 3,
                 keep_all: bool = False,
                 iterator=None,
                 normalizer=None,
                 background: bool = False):
        """``iterator``: a ``ResumableIterator`` whose position each
        checkpoint stores (``iteratorState.json``).  ``normalizer`` waits
        for ``data/normalizers.py`` (it raises until then).
        ``background``: write the zips on a save thread."""
        if normalizer is not None:
            raise NotImplementedError("normalizer= waits for data/normalizers.py, which is "
                                      "not ported yet")
        self.directory = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.every_seconds = save_every_seconds
        self.keep_last = None if keep_all else (keep_last or 3)
        self.iterator = iterator
        self._last_save_time = time.time()
        os.makedirs(directory, exist_ok=True)
        # the index is shared by the caller's thread, the save thread and
        # any thread calling save_now: one lock keeps it whole
        self._index_lock = threading.Lock()
        # rebuilt from what is on disk, so keep-last-K spans restarts
        self._saved: list[str] = _scan_checkpoints(directory)
        self._write_index()
        self._async = AsyncCheckpointer() if background else None

    # ------------------------------------------------------------- saving
    def _write_index(self) -> None:
        with atomic_write(os.path.join(self.directory, INDEX_NAME)) as tmp:
            with open(tmp, "w") as f:
                json.dump({"checkpoints": self._saved}, f)

    def _commit(self, path: str) -> None:
        """The index and the keep-last-K pruning after a write (on the save
        thread in background mode)."""
        with self._index_lock:
            if path in self._saved:      # the same iteration saved again
                self._saved.remove(path)
            self._saved.append(path)
            if self.keep_last is not None:
                while len(self._saved) > self.keep_last:
                    old = self._saved.pop(0)
                    if os.path.exists(old):
                        os.remove(old)
            self._write_index()

    def _save(self, model, iteration: int, epoch: int) -> str:
        from deeplearning4j_tpu_torch.io.model_serializer import write_model
        path = os.path.join(self.directory, f"checkpoint_iter{iteration}_epoch{epoch}.zip")
        it_state = (self.iterator.state()
                    if self.iterator is not None and hasattr(self.iterator, "state") else None)
        if self._async is not None:
            snap = snapshot_net(model)    # the host copy, now

            def job(snap=snap, path=path, it_state=it_state):
                write_model(snap, path, iterator_state=it_state)
                self._commit(path)

            self._async.submit(job)
        else:
            write_model(model, path, iterator_state=it_state)
            self._commit(path)
        self._last_save_time = time.time()
        return path

    def save_now(self, model, iteration: Optional[int] = None,
                 epoch: Optional[int] = None) -> str:
        """A checkpoint now, outside the schedule; the counters default to
        the model's own."""
        return self._save(model, model.iteration if iteration is None else iteration,
                          getattr(model, "epoch", 0) if epoch is None else epoch)

    def flush(self) -> None:
        """Wait for the pending background saves; raise a failed one."""
        if self._async is not None:
            self._async.flush()

    def close(self) -> None:
        if self._async is not None:
            self._async.close()

    # ---------------------------------------------------------- listener
    @staticmethod
    def _writer(model) -> bool:
        """Whether this process writes the scheduled checkpoints: under a
        data-parallel layout only rank 0 does (``Trainer`` marks the net),
        so each checkpoint is written once."""
        return getattr(model, "_writes_checkpoints", True)

    def iteration_done(self, model, iteration, epoch, score):
        if not self._writer(model):
            return
        if self.every_iter and iteration > 0 and iteration % self.every_iter == 0:
            self._save(model, iteration, epoch)
        elif self.every_seconds and time.time() - self._last_save_time >= self.every_seconds:
            self._save(model, iteration, epoch)

    def on_epoch_end(self, model, epoch, info):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0 and self._writer(model):
            self._save(model, model.iteration, epoch)

    def on_fit_end(self, model, info=None):
        # background saves are durable before fit returns
        self.flush()

    # ----------------------------------------------------------- lookups
    def last_checkpoint(self) -> Optional[str]:
        self.flush()
        with self._index_lock:
            return self._saved[-1] if self._saved else None

    @staticmethod
    def last_checkpoint_in(directory: str, verify: bool = True) -> Optional[str]:
        """The newest intact checkpoint under ``directory``, or None.  The
        candidates are the index's (rebased onto ``directory`` when the
        directory was moved) and a scan's, ordered by the (iteration,
        epoch) of their names; with ``verify`` each is checked newest
        first and a damaged one skipped and counted
        (``tpudl_resilience_corrupt_checkpoints_total``)."""
        index = os.path.join(directory, INDEX_NAME)
        saved: list[str] = []
        if os.path.exists(index):
            try:
                with open(index) as f:
                    saved = json.load(f).get("checkpoints", [])
            except (OSError, ValueError):
                saved = []   # a torn index: trust the directory
        rebased = []
        for path in saved:
            if not os.path.exists(path):
                local = os.path.join(directory, os.path.basename(path))
                path = local if os.path.exists(local) else path
            rebased.append(path)
        candidates = list(dict.fromkeys(rebased + _scan_checkpoints(directory)))

        def recency(item):
            position, path = item
            m = _CHECKPOINT_RE.match(os.path.basename(path))
            if m:
                return (1, int(m.group(1)), int(m.group(2)), position)
            return (0, 0, 0, position)

        for _, path in sorted(enumerate(candidates), key=recency, reverse=True):
            if not os.path.exists(path):
                continue
            if verify and not is_valid_checkpoint(path):
                get_registry().counter("tpudl_resilience_corrupt_checkpoints_total").inc()
                continue
            return path
        return None
