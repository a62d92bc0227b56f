"""DataSetIterator protocol and adapters (port of
``deeplearning4j_tpu/data/iterators.py``): an iterator is any iterable of
:class:`DataSet` with an optional ``reset()``."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base: iterable + reset."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


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
