"""Deprecated shim: context (sequence) parallelism moved to the unified
path (port of ``deeplearning4j_tpu/parallel/context_parallel.py``).

.. deprecated::
    Ring and Ulysses attention live in
    :mod:`deeplearning4j_tpu_torch.parallel.unified`; this module stays so
    that old imports keep working, and warns once on import.  New code
    imports them from ``parallel.unified`` or the
    ``deeplearning4j_tpu_torch.parallel`` package, which re-exports them.
"""

from __future__ import annotations

import warnings

from deeplearning4j_tpu_torch.parallel.unified import (  # noqa: F401
    NEG_INF, _block_attention, reference_attention, ring_attention, ulysses_attention)

warnings.warn(
    "deeplearning4j_tpu_torch.parallel.context_parallel is deprecated; import "
    "ring_attention/ulysses_attention from deeplearning4j_tpu_torch.parallel "
    "(unified-mesh path)",
    DeprecationWarning, stacklevel=2)
