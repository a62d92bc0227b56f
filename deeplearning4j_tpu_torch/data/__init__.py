"""Batch containers and iterators."""

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, DataSetIterator, ListDataSetIterator,
)

__all__ = ["DataSet", "DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator"]
