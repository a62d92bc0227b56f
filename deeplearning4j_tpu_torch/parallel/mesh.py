"""The mesh vocabulary and the layouts over it (port of
``deeplearning4j_tpu/parallel/mesh.py``).

Axis conventions, the JAX package's:

- ``data``   — batch sharding (DP); gradients are summed over this axis;
- ``model``  — tensor-parallel sharding of weight matrices (TP);
- ``seq``    — sequence/context parallelism (ring attention);
- ``pipe``   — pipeline stages;
- ``expert`` — expert parallelism (MoE).

The JAX package lays its axes over one ``jax.sharding.Mesh`` of devices
and lets GSPMD partition one program.  The port runs **one process per
data shard** over a ``torch.distributed`` process group (started by
``parallel.launcher.initialize`` or ``spawn_local_cluster``):

- :func:`make_mesh` gives a :class:`ProcessMesh`: the group, each rank's
  device and the axis sizes;
- :class:`MeshSpec` parses a layout flag (``"dp2"``) and builds the mesh;
- :class:`MeshLayout` is a resolved layout: this rank's rows of a batch
  (:meth:`MeshLayout.shard_batch`), the broadcast that makes every rank
  start from rank 0's trees (:meth:`MeshLayout.replicate`), the
  collectives of a step on the layout's group (a differentiable
  all-reduce for batch statistics, one flat all-reduce of the gradient in
  ``utils/pytree.py``'s order), a stable cache signature, the analytic
  collective bytes of a step and the ``tpudl_mesh_*`` gauges;
- :func:`resolve_layout` is the one rule behind every ``mesh=`` /
  ``layout=`` flag.

The collectives are the library's (``torch.distributed``), not kernels:
no TPU kernel stands behind them.  A gloo group takes CUDA tensors for
``all_reduce`` and ``broadcast`` (it stages them through the host), the
only two collectives a layout issues on the device; a step that holds
gloo collectives cannot be captured in a CUDA graph, so it runs eagerly
(:attr:`MeshLayout.captures`, and the step key says so).

The ``pipe``, ``data``, ``seq`` and ``expert`` axes are ported.  A mesh
lays its ranks out in :data:`MESH_AXES` order (``pipe`` outermost, the
last axis varying fastest), and every rank makes the subgroups of each
axis (:attr:`ProcessMesh.axis_groups`: ``seq``, ``data``, ``pipe``,
``expert``, in that order) in one order, since ``dist.new_group`` is
collective over the whole default group; a group is made once per set of
ranks (:func:`subgroup`), so a resize that returns to a width reuses the
groups made on the way.  A trainer's gradient collectives run on the data
subgroup: the ``seq`` ranks of one data position are replicas of its step
(``parallel.unified``'s attention shards the sequence over them), the
``pipe`` ranks of one data position its stages
(``parallel.pipeline_stages``), the ``expert`` ranks the shards of a MoE
layer's tokens and experts (``parallel.unified.moe_ffn``).  A layout
narrower than the world (``"dp2"`` in a gang of 4) takes the world's
leading ranks, as the JAX package's ``MeshSpec.build`` takes the leading
devices; the other ranks are parked (:attr:`ProcessMesh.member` is False)
until a resize takes them back.  A layout with ``model`` > 1 raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it.
:func:`resize_spec` and :func:`resize_layout` derive a layout at a new
width (the ``data`` axis scales; ``pipe``, ``seq`` and ``expert`` stay),
over the same world (``Trainer.resize_mesh``) or a gang relaunched at it
(the supervisor's resize).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import itertools
import math
import re
import threading
import time
from typing import Any, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.train.updaters import jax_leaves, jax_unflatten, tree_leaves

AXIS_PIPE = "pipe"
AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"

# every mesh's axes, in layout order (outermost → innermost)
MESH_AXES = (AXIS_PIPE, AXIS_DATA, AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL)

# the axes that shard the batch
DATA_AXES = (AXIS_DATA,)

# the JAX package's tensor-parallel rule families, by name (their rules
# come with the model-axis layouts)
TP_RULE_FAMILIES = ("dense", "bert")

# layout token → axis name for MeshSpec.parse ("dp2xtp2xpp2")
_LAYOUT_TOKENS = {
    "dp": AXIS_DATA, "tp": AXIS_MODEL, "pp": AXIS_PIPE, "sp": AXIS_SEQ, "ep": AXIS_EXPERT,
    AXIS_DATA: AXIS_DATA, AXIS_MODEL: AXIS_MODEL, AXIS_PIPE: AXIS_PIPE,
    AXIS_SEQ: AXIS_SEQ, AXIS_EXPERT: AXIS_EXPERT,
}

_TOKEN_RE = re.compile(r"([a-z]+)(\d+)")

# the ROADMAP.md item that ports each axis the port does not run yet
_NOT_PORTED_AXES = {
    AXIS_MODEL: "queue A item 2.5 (the model-axis layouts: tp, dp x tp and pipe x model, with "
                "the TP rule families)",
}

# the axes a process mesh makes subgroups for, in the order every rank makes them
_GROUP_AXES = (AXIS_SEQ, AXIS_DATA, AXIS_PIPE, AXIS_EXPERT)


@dataclasses.dataclass
class MeshSpec:
    """Axis sizes of a mesh: the parse target of every layout flag."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def total(self) -> int:
        return self.data * self.model * self.seq * self.pipe * self.expert

    def sizes(self) -> dict[str, int]:
        """Axis name → size, in :data:`MESH_AXES` vocabulary."""
        return {AXIS_PIPE: self.pipe, AXIS_DATA: self.data, AXIS_SEQ: self.seq,
                AXIS_EXPERT: self.expert, AXIS_MODEL: self.model}

    @classmethod
    def parse(cls, layout: str) -> "MeshSpec":
        """``"dp2xtp2xpp2"`` (or ``"data2_model2"``) → MeshSpec.  Tokens:
        dp=data, tp=model, pp=pipe, sp=seq, ep=expert; sizes are positive
        ints; the separators ``x``, ``_``, ``,`` and ``*`` are equivalent."""
        spec = cls()
        seen: set[str] = set()
        text = layout.strip().lower()
        if not text:
            raise ValueError("empty layout string")
        for part in re.split(r"[x_,*]+", text):
            if not part:
                continue
            m = _TOKEN_RE.fullmatch(part)
            if not m or m.group(1) not in _LAYOUT_TOKENS:
                raise ValueError(
                    f"unparseable layout token {part!r} in {layout!r} (tokens: dp/tp/pp/sp/ep "
                    f"or data/model/pipe/seq/expert + a positive size, e.g. 'dp2xtp2')")
            axis = _LAYOUT_TOKENS[m.group(1)]
            if axis in seen:
                raise ValueError(f"axis {axis!r} given twice in {layout!r}")
            seen.add(axis)
            size = int(m.group(2))
            if size < 1:
                raise ValueError(f"axis size must be >= 1 in {layout!r}")
            setattr(spec, axis, size)
        if not seen:
            raise ValueError(f"layout {layout!r} names no axis (tokens: dp/tp/pp/sp/ep + a "
                             f"positive size)")
        return spec

    @classmethod
    def from_mesh(cls, mesh: "ProcessMesh") -> "MeshSpec":
        shape = mesh.shape
        return cls(data=shape[AXIS_DATA], model=shape[AXIS_MODEL], seq=shape[AXIS_SEQ],
                   pipe=shape[AXIS_PIPE], expert=shape[AXIS_EXPERT])

    def describe(self) -> str:
        """The stable short form (``"dp2xtp2xpp2"``; ``"single"`` when
        trivial): the layout's label on metrics and cache keys."""
        parts = [f"{token}{size}" for token, size in
                 (("dp", self.data), ("tp", self.model), ("pp", self.pipe), ("sp", self.seq),
                  ("ep", self.expert)) if size > 1]
        return "x".join(parts) if parts else "single"

    def build(self, devices=None, group=None) -> "ProcessMesh":
        """The mesh of these sizes over the process group (:func:`make_mesh`)."""
        return make_mesh(data=self.data, model=self.model, seq=self.seq, pipe=self.pipe,
                         expert=self.expert, devices=devices, group=group)


def _refuse_unported(spec: MeshSpec) -> None:
    for axis, size in spec.sizes().items():
        if axis in _NOT_PORTED_AXES and size > 1:
            raise NotImplementedError(
                f"layout {spec.describe()!r}: the {axis!r} axis is not ported yet; "
                f"ROADMAP.md {_NOT_PORTED_AXES[axis]} ports it.  The port runs the data, seq, "
                f"pipe and expert axes (layout='dp<N>', 'dp<N>xsp<M>', 'pp<S>', 'dp<N>xpp<S>', "
                f"'ep<E>')")


# a parked rank waits at its trainer's next epoch boundary for as long as
# the ranks inside the layout train an epoch: the boundary's broadcast runs
# on a group of the world with this timeout (the world's own is the
# launcher's, minutes)
PARK_TIMEOUT_S = 6 * 3600.0

# every subgroup this process made, by its global ranks and timeout:
# dist.new_group is collective over the whole default group, so each is made
# once, by every rank, in the same order
_SUBGROUPS: dict = {}


def subgroup(ranks: Sequence[int], timeout_s: Optional[float] = None):
    """The process group of the default group's ``ranks`` (global ranks),
    made on the first call and cached; every rank of the default group must
    make the same calls in the same order, member or not."""
    import torch.distributed as dist
    key = (tuple(int(r) for r in ranks), timeout_s)
    group = _SUBGROUPS.get(key)
    if group is None:
        kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        group = _SUBGROUPS[key] = dist.new_group(ranks=list(key[0]), **kw)
    return group


def park_group(world=None):
    """The group a trainer's epoch boundary broadcasts on: the whole
    ``world`` (the default group, or a group given to :func:`make_mesh`),
    over the default group with :data:`PARK_TIMEOUT_S` as its timeout, so
    that a parked rank outwaits an epoch of the others."""
    import torch.distributed as dist
    if world is not None:
        return world
    return subgroup(range(dist.get_world_size()), PARK_TIMEOUT_S)


def _coords(flat: int, shape: dict) -> list:
    """A mesh position's coordinates, in :data:`MESH_AXES` order (the last
    axis varies fastest)."""
    coords = []
    for axis in reversed(MESH_AXES):
        flat, c = divmod(flat, shape[axis])
        coords.append(c)
    return coords[::-1]


def _flat(coords, shape: dict) -> int:
    flat = 0
    for c, axis in zip(coords, MESH_AXES):
        flat = flat * shape[axis] + c
    return flat


def _axis_groups(ranks: list, shape: dict, axis: str) -> list:
    """The rank lists of ``axis``'s groups over the mesh's ``ranks``: the
    ranks that differ in that axis's position alone, in order of their
    first rank."""
    at = MESH_AXES.index(axis)
    others = [range(shape[a]) if a != axis else range(1) for a in MESH_AXES]
    return [[ranks[_flat(pos[:at] + (k,) + pos[at + 1:], shape)] for k in range(shape[axis])]
            for pos in itertools.product(*others)]


class ProcessMesh:
    """The port's mesh: ranks of a ``torch.distributed`` world (the default
    group, or ``world``) laid out over the axes (:data:`MESH_AXES` order,
    one process per position), with each rank's device.  ``shape`` maps
    every axis to its size, as a ``jax.sharding.Mesh``'s does.

    The mesh takes the world's leading ``size`` ranks; a rank past them is
    parked (``member`` False, ``rank`` -1).  ``group`` is the mesh's group
    (the world itself when the mesh is as wide); ``axis_groups[axis]`` is
    this rank's group along an axis (the mesh's group where the axis spans
    it; None where the axis is 1 or the rank is parked) and
    ``axis_index[axis]`` its position on it (-1 when parked), for the
    ``seq``, ``data``, ``pipe`` and ``expert`` axes; ``data_group``,
    ``seq_group``, ``pipe_group``, ``expert_group`` and the ``*_index``
    attributes name them."""

    def __init__(self, shape: dict, world_devices: Sequence, world=None):
        import torch.distributed as dist
        self.shape = {axis: int(shape.get(axis, 1)) for axis in MESH_AXES}
        self.world = world
        self.world_rank = dist.get_rank(world)
        self.world_size = dist.get_world_size(world)
        self.backend = str(dist.get_backend(world))
        self.world_devices = [torch.device(d) for d in world_devices]
        if len(self.world_devices) != self.world_size:
            raise ValueError(f"{len(self.world_devices)} devices for a group of "
                             f"{self.world_size} ranks")
        self.size = math.prod(self.shape.values())
        if self.size > self.world_size:
            raise ValueError(f"a mesh of {self.size} ranks over a group of {self.world_size}")
        self.member = self.world_rank < self.size
        self.rank = self.world_rank if self.member else -1
        self.devices = self.world_devices[:self.size]
        # global ranks of the mesh's positions
        if world is None:
            ranks = list(range(self.size))
        else:
            ranks = [dist.get_global_rank(world, r) for r in range(self.size)]
        self.ranks = ranks
        narrow = self.size < self.world_size
        needs = narrow or any(1 < self.shape[a] < self.size for a in _GROUP_AXES)
        if needs and world is not None:
            raise ValueError("a mesh narrower than its group, or with two axes above 1, needs "
                             "subgroups of the default group: build it over the default group "
                             "(group=None)")
        # collective: every rank makes every group, in this order
        self.group = subgroup(ranks) if narrow else world
        self.axis_groups = {}
        for axis in _GROUP_AXES:
            n = self.shape[axis]
            mine = None
            if n == self.size:
                mine = self.group
            elif n > 1:
                for members in _axis_groups(ranks, self.shape, axis):
                    g = subgroup(members)
                    if self.member and ranks[self.rank] in members:
                        mine = g
            self.axis_groups[axis] = mine if self.member else None
        coords = _coords(self.rank, self.shape) if self.member else [-1] * len(MESH_AXES)
        self.axis_index = dict(zip(MESH_AXES, coords))
        self.seq_group, self.data_group, self.pipe_group, self.expert_group = (
            self.axis_groups[a] for a in (AXIS_SEQ, AXIS_DATA, AXIS_PIPE, AXIS_EXPERT))
        self.seq_index, self.data_index, self.pipe_index, self.expert_index = (
            self.axis_index[a] for a in (AXIS_SEQ, AXIS_DATA, AXIS_PIPE, AXIS_EXPERT))

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank of the process at ``index`` along ``axis`` from
        this rank (its other coordinates this rank's)."""
        coords = _coords(self.rank, self.shape)
        coords[MESH_AXES.index(axis)] = index
        return self.ranks[_flat(coords, self.shape)]

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.world_devices[self.world_rank]

    def __repr__(self) -> str:
        where = f"rank {self.rank} of {self.size}" if self.member else "parked"
        return (f"ProcessMesh({self.shape}, {where}, world {self.world_rank} of "
                f"{self.world_size}, {self.backend}, {[str(d) for d in self.devices]})")


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1, pipe: int = 1,
              expert: int = 1, devices=None, group=None) -> ProcessMesh:
    """The mesh over the initialized process group (``group``, or the
    default one) with axes ('pipe', 'data', 'seq', 'expert', 'model'),
    ``data`` defaulting to the ranks the other axes leave.  The mesh takes
    the group's leading ``data·seq·…`` ranks (the others are parked), so
    the group must have at least as many; every rank of the group calls
    it, in the same order as the others (it makes the axes' subgroups).
    ``devices`` is each rank's device: one for all of them (``"cuda"``: the
    ranks share the card, or each its current card; ``"cpu"``) or one per
    rank of the group; the card by default."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group, one process per "
            "data shard: start the processes with parallel.launcher.spawn_local_cluster, or "
            "call parallel.launcher.initialize(address, num_processes, process_id) in each")
    n = dist.get_world_size(group)
    if data is None:
        denom = model * seq * pipe * expert
        if n % denom:
            raise ValueError(f"{n} processes not divisible by model*seq*pipe*expert={denom}")
        data = n // denom
    spec = MeshSpec(data=data, model=model, seq=seq, pipe=pipe, expert=expert)
    if spec.total() > n:
        raise ValueError(
            f"layout {spec.describe()!r} needs {spec.total()} processes, the process group has "
            f"{n}: run one process per shard (parallel.launcher.initialize or "
            f"spawn_local_cluster with n_processes={spec.total()})")
    if devices is None:
        devices = DEFAULT_DEVICE
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    for d in devices:
        resolve_device(d)
    return ProcessMesh(spec.sizes(), devices, group)


@dataclasses.dataclass
class CollectiveStats:
    """What a layout's collectives of one kind did: calls, bytes reduced
    (the tensors' sizes) and the host seconds of the calls (for a CUDA
    tensor on gloo, the wait for the card to reach the call included,
    unless the call was timed: then the card caught up first); and, for an
    exchange that stages a CUDA tensor through the host itself
    (``parallel.unified``), the bytes copied to the host and back."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    staged_bytes: int = 0


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) over the layout's group whose backward is the
    all-reduce (sum) of the cotangent."""

    @staticmethod
    def forward(ctx, layout, kind, t):
        ctx.layout, ctx.kind = layout, kind
        out = t.contiguous().clone()
        layout.all_reduce_(out, kind)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        ctx.layout.all_reduce_(g, ctx.kind)
        return None, None, g


def broadcast_tree(tree, src: int = 0, group=None, count=None):
    """Every tensor of ``tree`` overwritten in place by rank ``src``'s (its
    rank in ``group``, the default group when None), one broadcast per
    dtype; ``count(kind, flat, seconds)`` is told of each.  Returns
    ``tree``."""
    import torch.distributed as dist
    root = src if group is None else dist.get_global_rank(group, src)
    leaves = [t for t in tree_leaves(tree) if torch.is_tensor(t)]
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        same = [t for t in leaves if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        t0 = time.perf_counter()
        dist.broadcast(flat, src=root, group=group)
        if count is not None:
            count("broadcast", flat, time.perf_counter() - t0)
        offset = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
    return tree


class MeshLayout:
    """A resolved layout over one :class:`ProcessMesh` (module docstring);
    construct it with :func:`resolve_layout`.  Its collectives
    (:meth:`all_reduce_`, :meth:`all_reduce_tree`) run on the data axis's
    group; a pipe layout's exchanges are ``parallel.pipeline_stages``'."""

    def __init__(self, spec: MeshSpec, mesh: Optional[ProcessMesh] = None,
                 tp_family: str = "dense", devices=None):
        _refuse_unported(spec)
        if tp_family not in TP_RULE_FAMILIES:
            raise ValueError(f"unknown TP rule family {tp_family!r} (have "
                             f"{sorted(TP_RULE_FAMILIES)})")
        self.spec = spec
        self.tp_family = tp_family
        self.mesh = mesh if mesh is not None else spec.build(devices)
        built = MeshSpec.from_mesh(self.mesh)
        if built.sizes() != spec.sizes():
            raise ValueError(f"mesh shape {self.mesh.shape} does not match layout spec "
                             f"{spec.sizes()}")
        self._stats_lock = threading.Lock()
        self.stats: dict[str, CollectiveStats] = {}
        self._shard = None

    # ------------------------------------------------------------ facts
    @property
    def data(self) -> int:
        return self.spec.data

    @property
    def pipe(self) -> int:
        return self.spec.pipe

    @property
    def expert(self) -> int:
        return self.spec.expert

    @property
    def model(self) -> int:
        return self.spec.model

    @property
    def rank(self) -> int:
        """This process's position on the data axis (-1 when parked)."""
        return self.mesh.data_index

    @property
    def member(self) -> bool:
        """Whether this process is inside the layout (False: parked)."""
        return self.mesh.member

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def captures(self) -> bool:
        """Whether a step holding this layout's collectives can be captured
        in a CUDA graph: NCCL's can, gloo's (host-staged) cannot."""
        return self.mesh.backend == "nccl"

    def describe(self) -> str:
        return self.spec.describe()

    def is_trivial(self) -> bool:
        return self.spec.total() == 1

    def cache_signature(self) -> str:
        """Deterministic string for step-cache keys: axis sizes, TP family
        and device kind, the JAX package's form; stable across processes."""
        return (f"layout:{self.describe()}|tp:{self.tp_family}"
                f"|devs:{self.spec.total()}:{self.mesh.device.type}")

    def step_signature(self) -> str:
        """:meth:`cache_signature`, plus ``|eager:<backend>`` where the
        layout's steps cannot be captured."""
        sig = self.cache_signature()
        return sig if self.captures else f"{sig}|eager:{self.mesh.backend}"

    def eager_reason(self) -> Optional[str]:
        """Why a step holding this layout's collectives runs eagerly, or
        None where it can be captured."""
        if self.captures:
            return None
        return (f"{self.mesh.backend} collectives stage through the host and cannot be "
                f"captured in a CUDA graph")

    # -------------------------------------------------------- placement
    def shard_batch(self, tree):
        """This rank's rows of every array of ``tree`` (a tensor, a numpy
        array, a list or tuple of them, None): the leading dim split into
        ``data`` contiguous blocks, as GSPMD shards it; it must divide."""
        def rows(a):
            if a is None:
                return None
            if isinstance(a, (list, tuple)):
                return type(a)(rows(v) for v in a)
            n = a.shape[0]
            if not self.member:
                raise RuntimeError(f"this rank is parked outside layout {self.describe()!r}: it "
                                   f"takes no rows until a resize takes it back")
            if n % self.data:
                raise ValueError(f"a batch of {n} does not split into {self.data} equal shards "
                                 f"(layout {self.describe()!r})")
            per = n // self.data
            return a[self.rank * per:(self.rank + 1) * per]
        return rows(tree)

    def replicate(self, tree, src: int = 0):
        """Every tensor of ``tree`` overwritten in place by rank ``src``'s
        (its rank in the mesh's group; one broadcast per dtype); returns
        ``tree``.  A mesh of one rank has nothing to take."""
        if self.mesh.size == 1:
            return tree
        return broadcast_tree(tree, src, self.mesh.group, count=self._count)

    # ------------------------------------------------------ collectives
    def _count(self, kind: str, t: torch.Tensor, seconds: float) -> None:
        with self._stats_lock:
            s = self.stats.setdefault(kind, CollectiveStats())
            s.calls += 1
            s.bytes += t.numel() * t.element_size()
            s.seconds += seconds

    def all_reduce_(self, t: torch.Tensor, kind: str = "other", timed: bool = False):
        """Sum ``t`` over the data axis's group, in place (no autograd),
        counted under ``kind`` with its host seconds; ``timed`` waits for the
        device first (not while a CUDA graph is being captured), so that they
        are the collective's alone.  Over one data position the sum is ``t``
        itself, and nothing is sent."""
        import torch.distributed as dist
        if self.data == 1:
            self._count(kind, t, 0.0)
            return t
        if timed and t.is_cuda and not torch.cuda.is_current_stream_capturing():
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.mesh.data_group)
        self._count(kind, t, time.perf_counter() - t0)
        return t

    def all_reduce_sum(self, t: torch.Tensor, kind: str = "batch_statistics") -> torch.Tensor:
        """The sum of ``t`` over the group, differentiable: its backward
        sums the cotangent over the group."""
        return _AllReduceSum.apply(self, kind, t)

    def data_shard(self):
        """This rank's ``nn.layers.base.DataShard``: batch statistics
        summed over the group by :meth:`all_reduce_sum`."""
        from deeplearning4j_tpu_torch.nn.layers.base import DataShard
        if self._shard is None:
            self._shard = DataShard(self.rank, self.data, self.all_reduce_sum)
        return self._shard

    def all_reduce_tree(self, tree, extra: Sequence[torch.Tensor] = (),
                        kind: str = "gradient"):
        """Every leaf of ``tree`` and every tensor of ``extra`` summed over
        the group in ONE all-reduce of their concatenation (the leaves in
        ``utils/pytree.py``'s flat order, then ``extra``), in the widest of
        their dtypes; returns (the summed tree, the summed ``extra``), each
        leaf in its own dtype."""
        leaves = jax_leaves(tree)
        parts = leaves + list(extra)
        dtype = functools.reduce(torch.promote_types, [p.dtype for p in parts])
        flat = torch.cat([p.reshape(-1).to(dtype) for p in parts])
        self.all_reduce_(flat, kind, timed=True)
        offset = 0

        def take(like):
            nonlocal offset
            out = flat[offset:offset + like.numel()].view(like.shape).to(like.dtype)
            offset += like.numel()
            return out
        summed = jax_unflatten(tree, take)
        return summed, [take(e) for e in extra]

    def reset_stats(self) -> dict:
        """The collective counts so far (kind → :class:`CollectiveStats`),
        then zeroed."""
        with self._stats_lock:
            out, self.stats = self.stats, {}
        return out

    # ------------------------------------------------------- cost model
    def collective_bytes_per_step(self, param_bytes: int, activation_bytes: int = 0) -> int:
        """Analytic per-step collective traffic (bytes) of this layout, the
        JAX package's ring model: the gradient all-reduce moves
        ``2·(n−1)/n · param_bytes`` on the data axis; on the pipe axis the
        boundary activations ride the ring forward and back (``2 ·
        activation_bytes``) and the gradients of every stage reach every
        rank (``2·(S−1)/S · param_bytes``).  An estimate: the exchanges'
        own counts are ``parallel.unified.reset_exchange_stats`` and
        :meth:`reset_stats`."""
        total = 0.0
        if self.data > 1:
            total += 2.0 * (self.data - 1) / self.data * param_bytes
        if self.pipe > 1:
            total += 2.0 * max(activation_bytes, 0)
            total += 2.0 * (self.pipe - 1) / self.pipe * param_bytes
        return int(total)

    # ---------------------------------------------------------- metrics
    def publish_metrics(self, param_bytes: Optional[int] = None,
                        activation_bytes: int = 0) -> None:
        """Stamp the ``tpudl_mesh_*`` gauges for this layout: the active
        layout, the axis sizes and the per-step collective-bytes
        estimate."""
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        reg.gauge("tpudl_mesh_devices").set(self.spec.total())
        axis_gauge = reg.labeled_gauge("tpudl_mesh_axis_size", label_names=("axis",))
        for axis, size in self.spec.sizes().items():
            axis_gauge.set(size, axis=axis)
        reg.labeled_gauge("tpudl_mesh_layout_active", label_names=("layout",)).set(
            1, layout=self.describe())
        if param_bytes is not None:
            reg.gauge("tpudl_mesh_collective_bytes").set(
                self.collective_bytes_per_step(param_bytes, activation_bytes))


class LayoutResizeError(ValueError):
    """A device width that a layout's fixed axes do not allow: raised by
    :func:`resize_spec` and :func:`resize_layout` when the width is not a
    positive multiple of the layout's non-data degree
    (``model·seq·expert·pipe``).  Typed, so that an elastic caller (the
    supervisor's resize) refuses the resize and keeps the width it has."""


def resize_spec(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """The ``MeshSpec`` of the same layout at a new width: only the
    ``data`` axis scales (the other axes cut the model and survive a grow
    or shrink, so ``dp2xpp2`` grown to 8 becomes ``dp4xpp2``).  A width
    that is no positive multiple of the non-data degree raises
    :class:`LayoutResizeError`."""
    fixed = spec.model * spec.seq * spec.expert * spec.pipe
    if n_devices < fixed or n_devices % fixed:
        detail = (f"pipeline layouts keep their {spec.pipe} stages across a resize"
                  if spec.pipe > 1 else "model/seq/expert axes are fixed across a resize")
        raise LayoutResizeError(
            f"cannot resize layout {spec.describe()!r} to {n_devices} device(s): width must be "
            f"a positive multiple of its non-data degree {fixed} ({detail})")
    return dataclasses.replace(spec, data=n_devices // fixed)


def resize_layout(layout: MeshLayout, n_devices: int, devices=None) -> MeshLayout:
    """The :class:`MeshLayout` of ``layout`` at a new width, over the same
    world as ``layout``'s mesh (the default group when it has none): a
    width the layout's axes do not allow raises :class:`LayoutResizeError`
    before any mesh is built; the world needs at least the new width's
    ranks (the mesh takes the leading ones, :func:`make_mesh`), which a
    gang relaunched at that width has (``resilience.supervisor``).  Every
    rank of the world calls it, as :func:`make_mesh`.  A width of 1 keeps
    its layout (:func:`resolve_layout` would give None), so that it can
    grow back."""
    spec = resize_spec(layout.spec, n_devices)
    mesh = getattr(layout, "mesh", None)
    world = None if mesh is None else mesh.world
    if devices is None and mesh is not None:
        devices = mesh.world_devices
    return MeshLayout(spec, mesh=spec.build(devices, group=world), tp_family=layout.tp_family)


def resolve_layout(mesh: Optional[ProcessMesh] = None, layout: Any = None,
                   tp_family: str = "dense", devices=None) -> Optional[MeshLayout]:
    """The ONE resolution rule behind every ``mesh=`` / ``layout=`` flag,
    the JAX package's:

    - ``layout``: a layout string (``"dp2"``), a :class:`MeshSpec`, or a
      resolved :class:`MeshLayout` (returned as it is);
    - ``mesh``: a :class:`ProcessMesh` (:func:`make_mesh`) whose axis
      sizes define the layout; with ``layout`` too, they must agree;
    - both ``None`` → ``None`` (the single-device path), and so does a
      trivial layout (one process in all).

    ``devices`` is each rank's device when the mesh is built here.  A
    layout whose axes are not ported raises ``NotImplementedError`` (before
    any process group is needed); one wider than the group raises
    ``ValueError`` (a narrower one takes the group's leading ranks and parks
    the rest); with no group initialized, ``RuntimeError``."""
    if layout is None and mesh is None:
        return None
    if isinstance(layout, MeshLayout):
        if mesh is not None and layout.mesh is not mesh:
            raise ValueError("pass mesh= or a resolved MeshLayout, not both")
        return None if layout.is_trivial() else layout
    spec: Optional[MeshSpec] = None
    if layout is not None:
        spec = layout if isinstance(layout, MeshSpec) else MeshSpec.parse(str(layout))
    if mesh is not None:
        mesh_spec = MeshSpec.from_mesh(mesh)
        if spec is not None and mesh_spec.sizes() != spec.sizes():
            raise ValueError(f"layout {spec.describe()!r} disagrees with the mesh's axis sizes "
                             f"{mesh.shape}")
        spec = mesh_spec
    _refuse_unported(spec)
    if spec.total() == 1:
        return None
    return MeshLayout(spec, mesh=mesh, tp_family=tp_family, devices=devices)

