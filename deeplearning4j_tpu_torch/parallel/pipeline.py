"""Pipeline parallelism: microbatched stage execution over the ``pipe``
mesh axis (port of ``deeplearning4j_tpu/parallel/pipeline.py``).

GPipe's fill-drain schedule over ``S + M - 1`` ticks (S stages, M
microbatches; bubble fraction (S-1)/(S+M-1)).  The JAX package runs it as
one ``shard_map`` program whose ``lax.ppermute`` passes each tick's
activations around a ring; the port runs one process per stage
(``parallel.make_mesh(pipe=S)``), and each tick a stage sends its output
up the pipe group, host-staged as ``parallel.pipeline_stages`` sends it
(``pipeline_stages._fill_drain``, which :func:`pipeline_stages.
pipeline_apply_stages` runs too).  ``stage_fn(stage_params, x)`` must keep
the shape ``[B_micro, ...]`` (the homogeneous path); heterogeneous stages
and the 1F1B training schedule live in ``parallel.pipeline_stages``.
"""

from __future__ import annotations

from typing import Callable, Optional

from deeplearning4j_tpu_torch.parallel.mesh import AXIS_PIPE


def pipeline_apply(stage_fn: Callable, stage_params, x, mesh, n_microbatches: int,
                   axis: str = AXIS_PIPE, data_axis: Optional[str] = None):
    """Run a homogeneous S-stage pipeline on this rank's stage of
    ``mesh``'s ``axis`` (every rank of the pipe group calls it together).

    - ``stage_params``: a tree whose leaves have a leading stage dim S
      (this rank takes its row), or this rank's block of them (leading
      dim 1): the JAX package's ``P(axis)`` operand;
    - ``x``: this rank's batch ``[B, ...]``, split into ``n_microbatches``
      chunks that enter at stage 0 and leave at stage S-1;
    - ``data_axis``: dp x pp: ``x`` is this rank's data position's rows,
      and its pipeline runs on them alone (the stage params are the same
      on every data position).

    Returns ``y [B, ...]``, the last stage's outputs, on every rank of the
    pipe group.  The ``pipeline`` span and
    ``tpudl_parallel_pipeline_calls_total`` mark each call."""
    from deeplearning4j_tpu_torch.obs import tracing
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    from deeplearning4j_tpu_torch.parallel.pipeline_stages import _fill_drain
    from deeplearning4j_tpu_torch.parallel.unified import _Axis
    from deeplearning4j_tpu_torch.train.updaters import tree_map
    pipe = _Axis(mesh, axis)
    data_par = mesh.shape[data_axis] if data_axis else 1
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches={n_microbatches} "
                         f"(this rank's rows)")

    def mine(a):
        return a[0] if a.shape[0] == 1 else a[pipe.index]

    with tracing.span("pipeline", stages=int(pipe.n), microbatches=n_microbatches,
                      data_parallel=int(data_par)):
        get_registry().counter("tpudl_parallel_pipeline_calls_total").inc()
        return _fill_drain(pipe, stage_fn, tree_map(mine, stage_params), x, n_microbatches)
