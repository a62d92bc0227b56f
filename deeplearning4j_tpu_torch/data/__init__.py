"""Batch containers and iterators."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, DataSetIterator, EarlyTerminationIterator,
    GeneratorDataSetIterator, ListDataSetIterator, ResumableIterator,
)

__all__ = ["DataSet", "MultiDataSet", "DataSetIterator", "ListDataSetIterator",
           "ArrayDataSetIterator", "ResumableIterator", "GeneratorDataSetIterator",
           "AsyncDataSetIterator", "EarlyTerminationIterator"]
