"""Feedback spool → resumable training stream (port of
``deeplearning4j_tpu/online/source.py``).

:class:`FeedbackSource` turns the serve layer's feedback spool
(:mod:`deeplearning4j_tpu_torch.serve.feedback`) into a
``DataSetIterator``-compatible stream the trainer can fit on — with the
property the whole online loop leans on: **a killed fine-tune resumed
from its checkpoint consumes exactly the records the uninterrupted run
would have, no duplicates, no gaps** (the resilience layer's 1e-6
exact-resume contract, extended to live feedback data).

How that works:

- The spool assigns every record a stable GLOBAL index (segment file
  names carry the start index, so rotation and pruning never renumber).
- A fine-tune **round** covers a window of records pinned by a **round
  stamp** — a tiny ``rounds/round-<r>.json`` written atomically the
  first time round ``r`` starts, recording ``[start, stop)`` and the
  sampling decision inputs.  A crashed round restarted on another
  process re-reads the stamp and derives the IDENTICAL batch sequence;
  new records that arrived in between belong to the next round, not a
  reshuffle of this one.
- Within a round, batch order is a pure function of ``(seed, round,
  stamp)`` — FIFO replays the window in spool order;
  ``sampling="reservoir"`` draws a uniform sample of the whole spool so
  old lessons aren't forgotten; ``sampling="recency"`` weights the draw
  exponentially toward the newest records.
- ``ResumableIterator`` wraps this source for the trainer: its
  mid-epoch ``batch_index`` fast-forward (checkpointed with the model)
  skips exactly the batches already consumed, which — because batch
  order is round-deterministic — is an exact record-level position.

``min_records`` gating belongs to the caller
(:class:`~deeplearning4j_tpu_torch.online.loop.OnlineTrainer` triggers a
round only when :meth:`pending` clears its threshold).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.resilience.checkpoint import atomic_write
from deeplearning4j_tpu_torch.serve import feedback as fb

SAMPLING_MODES = ("fifo", "reservoir", "recency")
ROUNDS_DIRNAME = "rounds"


class FeedbackSource(DataSetIterator):
    """One model's feedback spool as a round-windowed training stream.

    ``pin_round(r)`` selects which round the next pass iterates; the
    trainer-side ``set_epoch`` calls that ride in through
    ``ResumableIterator`` deliberately do NOT move the window — one
    fine-tune fit = one pinned round, however many epochs it runs and
    wherever its restored epoch counter happens to sit.
    """

    def __init__(self, spool_dir: str, batch_size: int = 16,
                 max_records_per_round: int = 1024,
                 sampling: str = "fifo", seed: int = 0,
                 model: Optional[str] = None,
                 weighted: bool = False):
        if sampling not in SAMPLING_MODES:
            raise ValueError(f"sampling must be one of {SAMPLING_MODES}, "
                             f"got {sampling!r}")
        self.spool_dir = spool_dir
        self.batch_size = max(1, int(batch_size))
        self.max_records_per_round = max(1, int(max_records_per_round))
        self.sampling = sampling
        self.seed = int(seed)
        self.model = model
        self.weighted = bool(weighted)
        self._round = 0
        self._last_batch_indices: list[int] = []

    # ------------------------------------------------------------ positions
    def _rounds_dir(self) -> str:
        return os.path.join(self.spool_dir, ROUNDS_DIRNAME)

    def _stamp_path(self, r: int) -> str:
        return os.path.join(self._rounds_dir(), f"round-{r}.json")

    def read_stamp(self, r: int) -> Optional[dict]:
        try:
            with open(self._stamp_path(r), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError, json.JSONDecodeError):
            return None

    def stamp_round(self, r: int) -> dict:
        """The round's window, pinned durably at first use: ``start`` =
        previous round's ``stop`` (0 for round 0), ``stop`` = spool
        write position now, capped at ``max_records_per_round``.  A
        restarted round re-reads the stamp instead of re-deriving, so
        records that arrived during the crash don't reshuffle it."""
        existing = self.read_stamp(r)
        if existing is not None:
            return existing
        start = 0
        if r > 0:
            prev = self.read_stamp(r - 1)
            if prev is None:
                raise ValueError(
                    f"round {r} cannot be stamped before round {r - 1} "
                    f"(rounds pin their windows sequentially)")
            start = int(prev["stop"])
        high = fb.record_count(self.spool_dir)
        stop = min(high, start + self.max_records_per_round)
        stop = max(stop, start)
        stamp = {"round": r, "start": start, "stop": stop,
                 "sampling": self.sampling, "seed": self.seed}
        os.makedirs(self._rounds_dir(), exist_ok=True)
        with atomic_write(self._stamp_path(r)) as tmp:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(stamp, f)
        return stamp

    def last_stamped_round(self) -> int:
        """Highest stamped round number (-1 when none)."""
        try:
            names = os.listdir(self._rounds_dir())
        except OSError:
            return -1
        rounds = [-1]
        for name in names:
            if name.startswith("round-") and name.endswith(".json"):
                try:
                    rounds.append(int(name[len("round-"):-len(".json")]))
                except ValueError:
                    continue
        return max(rounds)

    def consumed(self) -> int:
        """Spool position owned by already-stamped rounds (records at or
        past this index have not been assigned to any round yet)."""
        r = self.last_stamped_round()
        if r < 0:
            return 0
        stamp = self.read_stamp(r)
        return int(stamp["stop"]) if stamp else 0

    def pending(self) -> int:
        """Records spooled but not yet assigned to a round — the online
        trainer's ``min_records`` trigger reads this."""
        return max(0, fb.record_count(self.spool_dir) - self.consumed())

    def staleness_s(self) -> float:
        """Age of the oldest unassigned feedback record (0 when the
        spool is drained) — how far behind live traffic the loop is."""
        import time
        consumed = self.consumed()
        records = fb.read_records(self.spool_dir, start=consumed,
                                  stop=consumed + 1)
        if not records:
            return 0.0
        return max(0.0, time.time() - float(records[0][1].get("t", 0.0)))

    # ------------------------------------------------------------- iteration
    def pin_round(self, r: int) -> None:
        self._round = int(r)

    def set_epoch(self, epoch: int) -> None:
        """ResumableIterator hook.  The window stays pinned to the
        round; epoch changes only matter to shuffle-aware bases, and
        this source's order is already a pure function of the stamp."""
        # (deliberately not an error: the trainer pins restored epochs)

    def reset(self) -> None:
        pass

    def _round_indices(self, stamp: dict) -> list[int]:
        """Global record indices this round trains on, in batch order —
        a pure function of the stamp (exact resume depends on this)."""
        start, stop = int(stamp["start"]), int(stamp["stop"])
        if self.sampling == "fifo" or stop == 0:
            return list(range(start, stop))
        n = stop - start
        if n <= 0:
            return []
        rng = np.random.default_rng((self.seed, int(stamp["round"])))
        if self.sampling == "reservoir":
            # uniform over the whole retained spool up to the window's
            # high-water mark: replay keeps old lessons in the mix
            pool = np.arange(0, stop)
            take = min(n, pool.shape[0])
            return sorted(int(i) for i in
                          rng.choice(pool, size=take, replace=False))
        # recency: exponential weighting toward the newest records
        pool = np.arange(0, stop)
        weights = np.exp((pool - (stop - 1)) / max(1.0, 0.25 * stop))
        weights /= weights.sum()
        take = min(n, pool.shape[0])
        return [int(i) for i in rng.choice(pool, size=take, replace=False,
                                           p=weights)]

    def __iter__(self):
        stamp = self.stamp_round(self._round)
        indices = self._round_indices(stamp)
        if not indices:
            return
        lo, hi = min(indices), max(indices) + 1
        available = dict(fb.read_records(self.spool_dir, start=lo, stop=hi))
        order = [i for i in indices if i in available]   # pruned → gone
        for at in range(0, len(order), self.batch_size):
            chunk = order[at: at + self.batch_size]
            records = [available[i] for i in chunk]
            x = np.asarray([r["x"] for r in records], dtype=np.float32)
            y = np.asarray([r["y"] for r in records], dtype=np.float32)
            labels_mask = None
            if self.weighted:
                labels_mask = np.asarray([float(r.get("w", 1.0))
                                          for r in records], np.float32)
            self._last_batch_indices = list(chunk)
            yield DataSet(x, y, None, labels_mask)

    def __len__(self):
        stamp = self.read_stamp(self._round)
        if stamp is None:
            return 0
        n = max(0, int(stamp["stop"]) - int(stamp["start"]))
        return -(-n // self.batch_size)
