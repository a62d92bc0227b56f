"""DataSet and MultiDataSet, the batch containers (port of
``deeplearning4j_tpu/data/dataset.py``): features, labels and their
optional masks, as numpy arrays or tensors (a MultiDataSet holds a list
of each, the ``ComputationGraph`` batch).  The trainer moves a batch to
the net's device."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np


def _take(arr, lo: int, hi: int):
    return None if arr is None else arr[lo:hi]


@dataclasses.dataclass
class DataSet:
    features: Any = None
    labels: Any = None
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def _fields(self) -> tuple:
        return self.features, self.labels, self.features_mask, self.labels_mask

    def num_examples(self) -> int:
        return 0 if self.features is None else int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> tuple["DataSet", "DataSet"]:
        """The first ``n_train`` examples and the rest."""
        n = self.num_examples()
        return (DataSet(*(_take(a, 0, n_train) for a in self._fields())),
                DataSet(*(_take(a, n_train, n) for a in self._fields())))

    def shuffle(self, seed: int = 0) -> "DataSet":
        """The examples in the order of numpy's ``default_rng(seed)``
        permutation (the JAX package's), as numpy arrays."""
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        return DataSet(*(None if a is None else np.asarray(a)[idx] for a in self._fields()))

    def batch_by(self, batch_size: int) -> list["DataSet"]:
        """Consecutive batches of ``batch_size`` examples (the last may be
        shorter)."""
        n = self.num_examples()
        return [DataSet(*(_take(a, lo, lo + batch_size) for a in self._fields()))
                for lo in range(0, n, batch_size)]


@dataclasses.dataclass
class MultiDataSet:
    """N features arrays and M labels arrays (``MultiDataSet.java``), with
    optional per-array masks: the ``ComputationGraph`` batch type."""

    features: Sequence[Any] = dataclasses.field(default_factory=list)
    labels: Sequence[Any] = dataclasses.field(default_factory=list)
    features_masks: Optional[Sequence[Any]] = None
    labels_masks: Optional[Sequence[Any]] = None

    def num_examples(self) -> int:
        return 0 if not self.features else int(self.features[0].shape[0])
