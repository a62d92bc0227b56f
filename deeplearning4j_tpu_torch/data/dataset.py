"""DataSet — the batch container (port of
``deeplearning4j_tpu/data/dataset.py``): features, labels and their
optional masks, as numpy arrays or tensors.  The trainer moves a batch
to the net's device."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class DataSet:
    features: Any = None
    labels: Any = None
    features_mask: Optional[Any] = None
    labels_mask: Optional[Any] = None

    def num_examples(self) -> int:
        return 0 if self.features is None else int(self.features.shape[0])

    def batch_by(self, batch_size: int) -> list["DataSet"]:
        """Consecutive batches of ``batch_size`` examples (the last may be
        shorter)."""
        def take(arr, lo, hi):
            return None if arr is None else arr[lo:hi]
        n = self.num_examples()
        return [DataSet(*(take(a, lo, lo + batch_size) for a in
                          (self.features, self.labels, self.features_mask, self.labels_mask)))
                for lo in range(0, n, batch_size)]
