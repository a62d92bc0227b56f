"""Deprecated shim: expert parallelism moved to the unified path (port of
``deeplearning4j_tpu/parallel/expert_parallel.py``).

.. deprecated::
    The MoE FFN (capacity-bounded top-k routing, all-to-all dispatch over
    the ``expert`` axis) lives in
    :mod:`deeplearning4j_tpu_torch.parallel.unified`.  This module stays so
    that existing imports keep working; new code imports from
    ``parallel.unified`` (or the ``deeplearning4j_tpu_torch.parallel``
    package, which re-exports it).
"""

from __future__ import annotations

import warnings

from deeplearning4j_tpu_torch.parallel.unified import (  # noqa: F401
    _dispatch_tensors, _top_k_gates, init_moe_params, moe_ffn, moe_ffn_dense, shard_moe_params)

warnings.warn(
    "deeplearning4j_tpu_torch.parallel.expert_parallel is deprecated; import "
    "moe_ffn/init_moe_params/shard_moe_params from deeplearning4j_tpu_torch.parallel "
    "(the unified path)",
    DeprecationWarning, stacklevel=2)
