"""DataSetIterator protocol and adapters (port of
``deeplearning4j_tpu/data/iterators.py``): an iterator is any iterable of
:class:`DataSet` with an optional ``reset()``.  ``ResumableIterator``
tracks its position for a mid-epoch resume, ``AsyncDataSetIterator``
prefetches on a background thread (``DeviceFeeder``'s queue, on the
host), ``EarlyTerminationIterator`` caps an epoch and
``GeneratorDataSetIterator`` calls a factory each epoch."""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base: iterable + reset."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ResumableIterator(DataSetIterator):
    """Wraps an iterator with its position (epoch, batch index) and a
    fast-forward: after ``set_state`` the next pass skips the batches
    already consumed, so a mid-epoch restart neither replays nor drops
    data.  A base with ``set_epoch`` (a shuffling ``ArrayDataSetIterator``)
    is told the epoch before each pass, so a restored run sees the order
    of the epoch it was interrupted in."""

    def __init__(self, base: DataSetIterator):
        self.base = base
        self.epoch = 0
        self.batch_index = 0
        self._skip = 0
        self._restored = False

    def __iter__(self):
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(self.epoch)
        skipped = 0
        for batch in self.base:
            if skipped < self._skip:
                skipped += 1
                continue
            self.batch_index += 1
            yield batch
        self._skip = 0
        self._restored = False

    def reset(self):
        if self._restored:
            # a reset between set_state() and the first pass (fit resets at
            # every epoch's start) keeps the restored position and epoch
            if hasattr(self.base, "reset"):
                self.base.reset()
            return
        if self.batch_index or self._skip:
            self.epoch += 1
        self.batch_index = 0
        self._skip = 0
        if hasattr(self.base, "reset"):
            self.base.reset()

    def state(self) -> dict:
        return {"epoch": self.epoch, "batch_index": self.batch_index}

    def set_state(self, state: dict) -> None:
        self.epoch = int(state.get("epoch", 0))
        self._skip = int(state.get("batch_index", 0))
        self.batch_index = self._skip
        self._restored = True


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of DataSets, re-batched to ``batch_size`` when given."""

    def __init__(self, datasets: list[DataSet], batch_size: Optional[int] = None):
        if batch_size is None:
            self.datasets = list(datasets)
        else:
            self.datasets = [b for ds in datasets for b in ds.batch_by(batch_size)]

    def __iter__(self):
        return iter(self.datasets)

    def __len__(self):
        return len(self.datasets)


class ArrayDataSetIterator(DataSetIterator):
    """Batch one (features, labels) array pair, optionally shuffled per
    epoch.  The permutation is a pure function of ``(seed, epoch)``
    (numpy's ``default_rng((seed, epoch))``, as in the JAX package), so
    epoch N's order is the same in both packages and after a restore
    through :meth:`set_epoch`."""

    def __init__(self, features, labels, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0, features_mask=None, labels_mask=None, drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch the next pass shuffles for."""
        self.epoch = int(epoch)

    def __iter__(self):
        n = self.features.shape[0]
        idx = (np.random.default_rng((self.seed, self.epoch)).permutation(n)
               if self.shuffle else np.arange(n))
        stop = n - (n % self.batch_size) if self.drop_last else n
        for lo in range(0, stop, self.batch_size):
            sel = idx[lo: lo + self.batch_size]
            yield DataSet(self.features[sel], self.labels[sel],
                          None if self.features_mask is None else self.features_mask[sel],
                          None if self.labels_mask is None else self.labels_mask[sel])
        self.epoch += 1   # standalone multi-epoch use still varies the order

    def __len__(self):
        n = self.features.shape[0]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class GeneratorDataSetIterator(DataSetIterator):
    """Iterates what ``factory()`` gives, called anew for each pass."""

    def __init__(self, factory: Callable[[], Iterable[DataSet]]):
        self.factory = factory

    def __iter__(self):
        return iter(self.factory())


class AsyncDataSetIterator(DataSetIterator):
    """Prefetches up to ``queue_size`` batches on a background thread
    (``AsyncDataSetIterator.java``): a ``DeviceFeeder`` on the host, with
    no placement and no bucketing, so each yielded batch is a copy that
    owns its memory.  ``etl_wait_s`` is the time the consumer waited in
    the current pass."""

    def __init__(self, underlying: DataSetIterator, queue_size: int = 2):
        self.underlying = underlying
        self.queue_size = max(1, queue_size)
        self.etl_wait_s = 0.0

    def reset(self):
        if hasattr(self.underlying, "reset"):
            self.underlying.reset()

    def __iter__(self):
        from deeplearning4j_tpu_torch.data.device_pipeline import DeviceFeeder
        feeder = DeviceFeeder(depth=self.queue_size, bucketing=False, device="cpu")
        self.etl_wait_s = 0.0
        for fed in feeder.feed(self.underlying):
            self.etl_wait_s = feeder.etl_wait_s
            yield fed.batch
        self.etl_wait_s = feeder.etl_wait_s


class EarlyTerminationIterator(DataSetIterator):
    """At most ``max_batches`` batches a pass
    (``EarlyTerminationDataSetIterator.java``)."""

    def __init__(self, underlying: DataSetIterator, max_batches: int):
        self.underlying = underlying
        self.max_batches = max_batches

    def reset(self):
        if hasattr(self.underlying, "reset"):
            self.underlying.reset()

    def __iter__(self):
        for i, batch in enumerate(self.underlying):
            if i >= self.max_batches:
                return
            yield batch
