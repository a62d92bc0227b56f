"""Distributed training and parallelism (port of
``deeplearning4j_tpu/parallel/``), as far as it is ported:

- ``mesh``        — the axis constants, ``MeshSpec`` (the layout flag's
                    parse), ``make_mesh``, ``MeshLayout`` and
                    ``resolve_layout``: the layouts behind
                    ``Trainer(mesh=..., layout="dpN" | "ppS" | "dpNxppS")``,
                    one process per mesh position over
                    ``torch.distributed``;
- ``data_parallel`` — ``ParallelWrapper`` (a deprecated shim, imported
                    lazily: its module warns): the every-step mode, the
                    parameter-averaging mode and ZeRO-1;
- ``compression`` — the threshold and bitmap gradient codecs (numpy, and
                    their torch device twins), the residual accumulator and
                    the adaptive threshold;
- ``dcn``         — ``make_multislice_mesh`` (slices of several ranks as
                    process subgroups), the in-process, socket ring and
                    process-group transports and the compressed allreduce;
- ``dcn_trainer`` — ``MultiSliceTrainer``, the gradient-sharing path;
- ``launcher``    — ``torch.distributed`` initialisation and local
                    multi-process gangs;
- ``inference``   — ``ParallelInference``, a shim over the serving engine;
- ``unified``     — sequence-parallel attention over the ``seq`` axis
                    (``ring_attention``, ``ulysses_attention``,
                    ``reference_attention``) and the MoE FFN over the
                    ``expert`` axis (``moe_ffn``, ``moe_ffn_dense``,
                    ``init_moe_params``, ``shard_moe_params``), on each
                    rank's shard, and the pipe layout's step builder;
                    ``context_parallel`` and ``expert_parallel`` are its
                    deprecation shims, as in the JAX package;
- ``pipeline`` / ``pipeline_stages`` — microbatched stage parallelism over
                    the ``pipe`` axis, one process per stage (GPipe's
                    ``pipeline_apply``, the heterogeneous 1F1B
                    ``pipeline_train_step`` and its stage-local form).

Not ported yet: the model axis (``ROADMAP.md`` queue A item 2.5):
``unified.tp_jit`` and the ``tensor_parallel`` shim.  The name raises an
``AttributeError``, and the module an ``ImportError``, that says so.
"""

from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator, bitmap_decode,
    bitmap_decode_device, bitmap_encode, bitmap_encode_device, threshold_decode,
    threshold_decode_device, threshold_encode, threshold_encode_device,
)
from deeplearning4j_tpu_torch.parallel.dcn import (
    CompressedAllReducer, GroupTransport, InProcessTransport, MultiSliceMesh, SliceRelay,
    SocketTransport, make_multislice_mesh,
)
from deeplearning4j_tpu_torch.parallel.dcn_trainer import MultiSliceTrainer
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.parallel.launcher import initialize, spawn_local_cluster
from deeplearning4j_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_EXPERT, AXIS_MODEL, AXIS_PIPE, AXIS_SEQ, DATA_AXES, MESH_AXES, MeshLayout,
    LayoutResizeError, MeshSpec, make_mesh, resize_layout, resize_spec, resolve_layout,
)
from deeplearning4j_tpu_torch.parallel.unified import (
    init_moe_params, moe_ffn, moe_ffn_dense, reference_attention, ring_attention,
    shard_moe_params, ulysses_attention,
)

__all__ = [
    "AXIS_DATA", "AXIS_EXPERT", "AXIS_MODEL", "AXIS_PIPE", "AXIS_SEQ", "MESH_AXES", "DATA_AXES",
    "MeshSpec", "MeshLayout", "make_mesh", "resolve_layout", "ParallelWrapper",
    "threshold_encode", "threshold_decode", "bitmap_encode", "bitmap_decode",
    "threshold_encode_device", "threshold_decode_device", "bitmap_encode_device",
    "bitmap_decode_device", "EncodedGradientsAccumulator", "AdaptiveThresholdAlgorithm",
    "InProcessTransport", "SocketTransport", "CompressedAllReducer", "MultiSliceTrainer",
    "ParallelInference", "initialize", "spawn_local_cluster", "make_multislice_mesh",
    "MultiSliceMesh", "GroupTransport", "SliceRelay", "resize_spec", "resize_layout",
    "LayoutResizeError", "ring_attention", "ulysses_attention", "reference_attention",
    "moe_ffn", "moe_ffn_dense", "init_moe_params", "shard_moe_params",
]

# the JAX package's parallel names that wait for the model axis
NOT_PORTED = {"tp_jit": "unified"}
NOT_PORTED_MODULES = ("tensor_parallel",)
NOT_PORTED_ITEM = "ROADMAP.md queue A item 2.5 (the model axis)"


def not_ported(module: str) -> None:
    """Raise the ``ImportError`` of a parallel module that waits for a
    later slice (each such module calls this at import)."""
    name = module.rsplit(".", 1)[-1]
    raise ImportError(f"{module} is not ported yet (the JAX package's parallel/{name}.py; "
                      f"{NOT_PORTED_ITEM} ports it); the port's parallel package has "
                      f"{', '.join(__all__)}")


def __getattr__(name):
    # ParallelWrapper resolves lazily: its module is a deprecation shim that
    # warns on import, which users who never touch it must not see
    if name == "ParallelWrapper":
        from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
        return ParallelWrapper
    if name in NOT_PORTED or name in NOT_PORTED_MODULES:
        where = NOT_PORTED.get(name, name)
        raise AttributeError(
            f"deeplearning4j_tpu_torch.parallel.{name} is not ported yet (the JAX package's "
            f"parallel/{where}.py; {NOT_PORTED_ITEM} ports it); the port's parallel package has "
            f"{', '.join(__all__)}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
