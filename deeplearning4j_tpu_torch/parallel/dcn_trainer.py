"""Multi-slice training: compressed gradient exchange between slices
(port of ``deeplearning4j_tpu/parallel/dcn_trainer.py``).

This is the SharedTrainingMaster counterpart for the cross-slice regime:
the reference trains each worker on its own data and pushes threshold-
encoded gradient deltas to the others, with residual error feedback.
Each slice leader runs, per step:

    residual += grad → adaptive-threshold encode → exchange the wire
    messages (a ring :class:`~deeplearning4j_tpu_torch.parallel.dcn.SocketTransport`
    across processes, :class:`~deeplearning4j_tpu_torch.parallel.dcn.InProcessTransport`
    within one) → decode and sum them in global rank order → apply

- ``device_encode=True`` (the default) computes the gradient, adds the
  residual and encodes it in ONE captured step on the slice's device, so
  only the fixed-capacity message (``3 + 2·capacity`` int32s) is copied to
  the host, not the dense gradient; the peers' messages are decoded and
  summed on the device, and the update applied, in a second captured
  step.  τ changes every step: it is written into a device scalar before
  the step runs.  ``device_encode=False`` is the host codec's path (the
  correctness oracle): the dense gradient to the host, the numpy codec,
  the summed total back.
- ``overlap=True`` double-buffers the exchange: step N's messages travel
  on an IO thread while step N+1's gradients compute, and land one step
  late on every slice alike.
- Multi-process: give each process a ring ``SocketTransport`` and set
  ``world_size``/``rank_offset``; the per-slice arithmetic is the same.

Every slice applies the same total, added in the same order, so the
slices' params stay byte-identical with no broadcast; the quantization
error stays in each slice's residual.  Layer statistics (BatchNorm's
running mean and variance) are per slice, each taken over the slice's
own sub-batch, and :meth:`MultiSliceTrainer.collect` averages them in
f32, as the reference's model collection does.

Slices on one card are asked for as ``devices=[dev] * n``: each holds its
own copy of the params, state, updater state and residual, and its own
captured steps (one graph each, so no slice's trees are copied into
another's buffers), and the slices' steps on one device take turns.

Slices of several ranks (``data_per_slice > 1``, or ``layout="dpN"``):
one process per rank over ``torch.distributed``, laid out by
``parallel.dcn.make_multislice_mesh`` (rank ``s·d + j`` is data rank
``j`` of slice ``s``).  Each process runs its slice's dense step
(``parallel.mesh.MeshLayout`` on the slice's subgroup): its rows of the
slice's share of the global batch, batch statistics summed over the
slice by the differentiable all-reduce, dropout masks of the slice's
batch, and the flat gradient and loss all-reduced over the slice.  Every
rank of a slice then holds the same gradient, residual and τ, and
encodes the same message; only the slice's leader exchanges it with the
other leaders, and hands the peers' messages to the rest of its slice
(``parallel.dcn.SliceRelay``), so every rank decodes and applies the same
bytes.  A slice step on gloo runs eagerly.  Each trainer step stamps the
cluster telemetry (``obs.remote.notify_step``).

Not ported yet: the cost model's analysis of the slice step.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.config import resolve_device
from deeplearning4j_tpu_torch.obs import flight_recorder, tracing
from deeplearning4j_tpu_torch.obs import remote as obs_remote
from deeplearning4j_tpu_torch.obs.listeners import ListenerBus
from deeplearning4j_tpu_torch.obs.registry import get_registry
from deeplearning4j_tpu_torch.parallel import mesh as mesh_mod
from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, compact_device_message, decode_sum_device, pad_to_device_layout,
    threshold_decode_device, threshold_decode_values_device, threshold_encode_device,
    threshold_encode_values_device)
from deeplearning4j_tpu_torch.parallel.dcn import (CompressedAllReducer, InProcessTransport,
                                                   MultiSliceMesh, SliceRelay,
                                                   make_multislice_mesh)
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.faults import InjectedCrash, InjectedFault
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, TransientError, with_retries
from deeplearning4j_tpu_torch.train import step_cache
from deeplearning4j_tpu_torch.train.capture import CapturedStep, write_into
from deeplearning4j_tpu_torch.train.trainer import (
    STREAM_SEED_OFFSET, _batch_masks, make_loss_fn, net_optimizer)
from deeplearning4j_tpu_torch.train.updaters import jax_leaves, tree_map
from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector, unflatten_param_vector


def _slice_mesh(net, n_slices: int, data_per_slice: int, devices, mesh):
    """The multi-slice mesh of a trainer whose slices have several ranks:
    ``mesh`` as given (its shape checked), else made over the initialized
    group, which must hold ``n_slices × data_per_slice`` processes."""
    import torch.distributed as dist
    if mesh is not None:
        if not isinstance(mesh, MultiSliceMesh):
            raise TypeError(f"mesh must be a MultiSliceMesh (make_multislice_mesh), got "
                            f"{type(mesh).__name__}")
        # the mesh's own width when the trainer was not given one
        data_per_slice = mesh.data_per_slice if data_per_slice == 1 else data_per_slice
        if (mesh.n_slices, mesh.data_per_slice) != (n_slices, data_per_slice):
            raise ValueError(f"the mesh has {mesh.n_slices} slices x {mesh.data_per_slice}, the "
                             f"trainer was asked for {n_slices} x {data_per_slice}")
        return mesh
    need = n_slices * data_per_slice
    how = (f"{n_slices} slices x data_per_slice={data_per_slice} run one process per rank: "
           f"start {need} with parallel.launcher.spawn_local_cluster (or initialize in each) "
           f"and lay them out with parallel.make_multislice_mesh (or pass mesh=)")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"no torch.distributed process group is initialized; {how}")
    if dist.get_world_size() != need:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks; {how}")
    return make_multislice_mesh(n_slices, data_per_slice,
                                devices=net.device if devices is None else devices)


def _exchange_retryable(e: BaseException) -> bool:
    """The ring exchange is NOT idempotent: the transport moves its round
    counter (and may have sent frames) before it fails, so replaying a
    timed-out exchange would desync the gang.  Only errors raised before
    the transport touched its state retry: ``TransientError`` (a transport
    that raises one vouches for its idempotency) and injected faults
    (fired ahead of the transport call)."""
    if isinstance(e, InjectedCrash):
        return False
    return isinstance(e, (TransientError, InjectedFault))


def _copy_tree(tree, device):
    """A tree's tensors copied onto ``device`` (anything else as it is)."""
    return tree_map(lambda t: t.detach().to(device, copy=True) if torch.is_tensor(t) else t,
                    tree)


def _default_devices(net) -> list:
    dev = net.device
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _as_tensor(v, device):
    if v is None:
        return None
    if torch.is_tensor(v):
        return v.to(device)
    return torch.as_tensor(np.ascontiguousarray(v)).to(device)


class _SliceSteps:
    """The captured steps of one kind, one per local slice index, built on
    first use: the step cache holds this under the reference's key, and
    each slice replays a graph of its own."""

    def __init__(self, build):
        self._build = build
        self._steps: dict[int, CapturedStep] = {}
        self._lock = threading.Lock()

    def get(self, index: int) -> CapturedStep:
        with self._lock:
            step = self._steps.get(index)
            if step is None:
                step = self._steps[index] = self._build(index)
            return step

    @property
    def graph_count(self) -> int:
        with self._lock:
            return sum(s.graph_count for s in self._steps.values())

    @property
    def switches(self) -> int:
        with self._lock:
            return sum(s.switches for s in self._steps.values())


def _flat_grads(loss_fn, layout=None, dtype=torch.float32):
    """``(params, state, *args) -> (loss, new_state, flat)``: the loss, the
    layers' new state, and the gradient in every param (zeros where the
    loss never reads one) raveled in ``flat_param_vector`` order, in
    ``dtype`` (None: the params').  Under a slice's ``layout`` the loss is
    this rank's share and the gradient and loss are summed over the
    slice's ranks in one all-reduce: the slice's."""

    def grads(params, state, *args):
        grad_params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = jax_leaves(grad_params)
        with torch.enable_grad():
            loss, new_state = loss_fn(grad_params, state, *args)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          .to(dtype or p.dtype) for p, g in zip(leaves, flat)])
        loss = loss.detach()
        if layout is not None:
            both = torch.cat([flat, loss.reshape(1).to(flat.dtype)])
            layout.all_reduce_(both, "gradient", timed=True)
            flat, loss = both[:-1], both[-1].to(loss.dtype)
        return loss, new_state, flat

    return grads


class MultiSliceTrainer:
    """Train one model across slices with compressed cross-slice gradient
    exchange (workload #5 across slices).

    In one process each local slice is a pool thread owning a device (a
    card, or a share of one: ``devices=[dev] * n``); across processes each
    process owns its local slice(s) and a ring transport, ``world_size``
    is the global slice count and ``rank_offset`` this process's first
    global rank.  ``fit``/``fit_batch`` mirror the Trainer; the process's
    batch splits evenly across its local slices.

    With ``data_per_slice > 1`` (or ``layout="dpN"``, or a ``mesh`` from
    ``make_multislice_mesh``) each process is one rank of one slice (the
    module docstring): ``n_slices`` is the GLOBAL slice count, every rank
    calls the trainer with the same net and the same global batches, this
    process's slice takes its share of each and its rank its rows of
    that, and ``fit_batch`` returns the slice's loss.  ``transports``
    (optional) is the leader's cross-slice transport, ``[t]``; by default
    the leaders exchange over their subgroup.  Without an initialized
    group of ``n_slices × data_per_slice`` processes it raises.
    ``max_param_divergence`` is then collective: every rank calls it, and
    it reads the largest distance between any two ranks' params."""

    def __init__(self, net, n_slices: int, data_per_slice: int = 1,
                 devices: Optional[Sequence] = None, transports: Optional[Sequence] = None,
                 algorithm: Optional[AdaptiveThresholdAlgorithm] = None,
                 use_native: bool = True, value_coded: bool = True,
                 device_encode: bool = True, capacity: Optional[int] = None,
                 overlap: bool = False, world_size: Optional[int] = None, rank_offset: int = 0,
                 listeners=None, retry_policy: Optional[RetryPolicy] = None, layout=None,
                 mesh: Optional[MultiSliceMesh] = None):
        if layout is not None:
            # the per-slice layout in Trainer's vocabulary: "dp2" = 2
            # data-parallel devices per slice; other axes ride one slice
            spec = (layout if isinstance(layout, mesh_mod.MeshSpec)
                    else mesh_mod.MeshSpec.parse(str(layout)))
            if spec.model > 1 or spec.pipe > 1 or spec.seq > 1 or spec.expert > 1:
                raise NotImplementedError(
                    f"MultiSliceTrainer layouts compose DCN × data today (got "
                    f"{spec.describe()!r}); run model/pipe/seq/expert axes through "
                    f"Trainer(layout=...) on one slice")
            data_per_slice = spec.data
        self._mesh: Optional[MultiSliceMesh] = None
        self._layout = None
        if data_per_slice > 1 or mesh is not None:
            self._mesh = mesh = _slice_mesh(net, n_slices, data_per_slice, devices, mesh)
            self._layout = mesh.layout()
            transport = None
            if mesh.is_leader:
                transport = (transports[0] if transports is not None and transports[0] is not None
                             else mesh.transport())
            transports = [SliceRelay(mesh, transport)]
            world_size, rank_offset = n_slices, mesh.slice_index
            n_slices, data_per_slice, devices = 1, 1, [mesh.device]
        # this process's wire messages go out (a slice's other ranks hand
        # theirs to no transport)
        self._sends = self._mesh is None or self._mesh.is_leader
        self.net = net
        self.n_slices = n_slices                      # local slices
        self.world_size = world_size or n_slices      # global slices
        self.rank_offset = rank_offset
        self.value_coded = value_coded
        self.device_encode = device_encode
        self.overlap = overlap
        self.bus = listeners if isinstance(listeners, ListenerBus) else ListenerBus(listeners)
        devices = list(devices if devices is not None else _default_devices(net))
        need = n_slices * data_per_slice
        if len(devices) < need:
            raise ValueError(f"need {need} devices, have {len(devices)}")
        self.devices = [resolve_device(d) for d in devices[:need]]

        if net.params_ is None:
            net.init()
        self.tx = net_optimizer(net)
        if net.opt_state is None:
            net.opt_state = self.tx.init(net.params_)
        self.grad_size = sum(leaf.numel() for leaf in jax_leaves(net.params_))
        self._placed = self._mesh is None
        if transports is None:
            if self.world_size != n_slices:
                # an InProcessTransport(world_size) with fewer local slices
                # would block every step until its timeout
                raise ValueError(
                    f"world_size={self.world_size} != n_slices={n_slices} requires explicit "
                    f"per-slice transports (e.g. a ring SocketTransport per process)")
            shared = InProcessTransport(self.world_size)
            transports = [shared] * n_slices
        self.transports = list(transports)
        mk_alg = (AdaptiveThresholdAlgorithm if algorithm is None
                  else partial(dataclasses.replace, algorithm))
        # the message capacity, shared by both paths so that their wires are
        # the same bits under overflow: headroom over the adaptive target
        # sparsity, bounded so that a message is always STRICTLY smaller
        # than the dense gradient
        alg0 = mk_alg()
        dense_bound = (self.grad_size - 4) // 2 if value_coded else self.grad_size - 4
        self.capacity = capacity or max(1, min(
            dense_bound, max(1024, int(4 * alg0.target_sparsity * self.grad_size))))
        if device_encode:
            # per-slice threshold state (the reference's algorithm is per worker)
            self.algorithms = [mk_alg() for _ in range(n_slices)]
            # a one-leaf tree each: the captured step updates it in place
            self.slice_residual = [[torch.zeros((self.grad_size,), dtype=torch.float32,
                                                device=d)] for d in self.devices]
            self._tau = [torch.zeros((), dtype=torch.float32, device=d) for d in self.devices]
            self.reducers = []
        else:
            self.algorithms = []
            self.reducers = [CompressedAllReducer(
                rank_offset + r, self.grad_size, self.transports[r], algorithm=mk_alg(),
                use_native=use_native, value_coded=value_coded, max_elements=self.capacity)
                for r in range(n_slices)]

        # per-slice replicas: the same values, each slice's own tensors
        self.slice_params = [_copy_tree(net.params_, d) for d in self.devices]
        self.slice_state = [_copy_tree(net.state_, d) for d in self.devices]
        self.slice_opt = [_copy_tree(net.opt_state, d) for d in self.devices]
        seed = int(getattr(net.conf, "seed", 0) or 0) + STREAM_SEED_OFFSET
        self._streams = [torch.Generator(device=d).manual_seed(seed + rank_offset + r)
                         for r, d in enumerate(self.devices)]
        # one slice at a time on a device: their steps share its stream
        self._device_locks = {d: threading.Lock() for d in self.devices}

        self._steps: Optional[dict] = None
        self._pool = ThreadPoolExecutor(max_workers=n_slices)
        # a separate IO lane, so an in-flight exchange never blocks compute
        self._io_pool = ThreadPoolExecutor(max_workers=n_slices)
        self._pending = [None] * n_slices   # overlap: in-flight exchanges
        self._step_ctx = None               # the step span's context, for the threads
        self._wire_tmp: list = [None] * n_slices
        # a flaky exchange must not kill the gang: retry with backoff under
        # a deadline (a shared, frozen policy), narrowly classified
        # (_exchange_retryable: the exchange is not idempotent)
        self._retry_policy = retry_policy or RetryPolicy(
            max_attempts=4, deadline_s=60.0, base_delay_s=0.05, retryable=_exchange_retryable)
        self.iteration = 0
        self.last_wire_stats: list[dict] = []

    # ------------------------------------------------------------ steps
    def _ensure_ready(self):
        if self._steps is not None:
            return
        net = self.net
        layout = self._layout
        if not self._placed:
            # every rank starts from global rank 0's trees
            mesh_mod.broadcast_tree([self.slice_params[0], self.slice_state[0],
                                     self.slice_opt[0]])
            self._placed = True
        loss_fn = make_loss_fn(net, shard=None if layout is None else layout.data_shard())
        grads = _flat_grads(loss_fn, layout)
        tx = self.tx
        size, cap, world = self.grad_size, self.capacity, self.world_size
        value_coded = self.value_coded
        # the process-level step cache: a rebuilt trainer over the same
        # configuration and codec geometry reuses the captured steps
        base_key = None
        net_sig = step_cache.net_signature(net)
        tx_sig = step_cache.updater_signature(net.conf)
        # a slice of several ranks builds its own: its steps close over
        # its layout's subgroups
        if net_sig is not None and tx_sig is not None and tx.labels is None \
                and tx.frozen is None and layout is None:
            base_key = net_sig + (tx_sig, step_cache.sharding_signature(None), size, cap, world,
                                  value_coded)

        def apply_total(params, opt_state, total):
            grad_tree = unflatten_param_vector(total, params)
            updates, new_opt_state = tx.update(grad_tree, opt_state, params)
            tree_map(lambda p, u: p.add_(u), params, updates)
            write_into(opt_state, new_opt_state)
            return params, opt_state

        def grad_step(params, state, features, labels, fmask, lmask, rng):
            loss, new_state, flat = grads(params, state, features, labels, fmask, lmask, rng)
            with torch.no_grad():
                write_into(state, new_state)
            return loss, flat

        def apply_step(params, opt_state, total):
            with torch.no_grad():
                return apply_total(params, opt_state, total)

        # the device codec's path: residual and encode in the gradient's
        # step; only the fixed-size message leaves the device
        def grad_encode_step(params, state, residual, features, labels, fmask, lmask, rng,
                             tau):
            loss, new_state, flat = grads(params, state, features, labels, fmask, lmask, rng)
            with torch.no_grad():
                acc = residual[0] + flat
                if value_coded:
                    msg = threshold_encode_values_device(acc, tau, cap)
                    dec = threshold_decode_values_device(msg, size, cap)
                else:
                    msg = threshold_encode_device(acc, tau, cap)
                    dec = threshold_decode_device(msg, size)
                res = acc - dec
                residual[0].copy_(res)
                write_into(state, new_state)
                return loss, msg, res.abs().max()

        def decode_apply_step(params, opt_state, padded_messages):
            with torch.no_grad():
                # global rank order: the same bits on every slice
                total = decode_sum_device(padded_messages, size, cap, value_coded)
                return apply_total(params, opt_state, total / world)

        kinds = {"dcn_grad": (grad_step, 2), "dcn_apply": (apply_step, 2),
                 "dcn_grad_encode": (grad_encode_step, 3),
                 "dcn_decode_apply": (decode_apply_step, 2)}
        self._steps = {}
        for kind, (fn, n_trees) in kinds.items():
            key = None if base_key is None else base_key + (kind,)

            def build(fn=fn, n_trees=n_trees, key=key, kind=kind):
                return _SliceSteps(lambda i: CapturedStep(
                    fn, n_trees, (key or kind, i),
                    eager_reason=None if layout is None else layout.eager_reason()))
            self._steps[kind] = step_cache.get_or_build(key, build)

    def _step(self, kind: str, rank: int, *args):
        """Run slice ``rank``'s step of ``kind``, one slice at a time on
        its device."""
        with self._device_locks[self.devices[rank]]:
            return self._steps[kind].get(rank)(*args)

    # ----------------------------------------------------------- training
    def _exchange(self, rank: int, compact: np.ndarray, parent=None) -> torch.Tensor:
        """Ring-exchange one slice's compact wire message; returns the
        ``[world, fixed layout]`` stack in global rank order, on the
        slice's device.  ``parent`` carries the slice span's context onto
        the IO thread (overlap mode)."""
        t0 = time.perf_counter()
        # the liveness stamp BEFORE the wire: a stalled exchange then shows
        # as "last site dcn.exchange" in the flight recorder's dump
        flight_recorder.progress("dcn.exchange")
        with tracing.span("exchange", parent=parent, slice=rank,
                          wire_bytes=int(compact.size) * 4):
            grank = self.rank_offset + rank

            def _do_exchange():
                # the fault site first: a delay models a slow hop, an
                # error runs the retry path per attempt
                faults.fire("dcn.exchange")
                return self.transports[rank].exchange(grank, compact)

            peers = with_retries(_do_exchange, policy=self._retry_policy, site="dcn.exchange")
            ordered = peers[:grank] + [compact] + peers[grank:]
            stack = np.stack([pad_to_device_layout(m, self.capacity) for m in ordered])
            out = torch.from_numpy(stack).to(self.devices[rank])   # on the IO thread too
        dt = time.perf_counter() - t0
        get_registry().histogram("tpudl_dcn_exchange_seconds").observe(dt)
        flight_recorder.progress("dcn.exchange")
        flight_recorder.record("exchange", slice=rank, rank=self.rank_offset + rank,
                               wire_bytes=int(compact.size) * 4,
                               duration_ms=round(dt * 1e3, 3))
        return out

    def _place(self, rank, parts):
        if self._layout is not None:
            parts = self._layout.shard_batch(list(parts))   # this rank's rows of the slice's
        return [_as_tensor(v, self.devices[rank]) for v in parts]

    def _slice_step_device(self, rank, features, labels, fmask, lmask):
        """Device codec: gradient, residual and encode in one captured
        step; only the message is copied to the host; the peers' messages
        are decoded and applied on the device.  With ``overlap`` step N's
        exchange rides the IO pool while step N+1 computes."""
        with tracing.span("slice", parent=self._step_ctx, slice=rank) as sp:
            f, l, fm, lm = self._place(rank, (features, labels, fmask, lmask))
            alg = self.algorithms[rank]
            tau = self._tau[rank]
            tau.fill_(alg.current())   # a device scalar, written before the step
            with tracing.span("encode", slice=rank):
                loss, msg, res_linf = self._step(
                    "dcn_grad_encode", rank, self.slice_params[rank], self.slice_state[rank],
                    self.slice_residual[rank], f, l, fm, lm, self._streams[rank], tau)
                msg_np = msg.cpu().numpy()   # the ONLY bulk copy to the host: 3+2cap int32s
            compact = compact_device_message(msg_np, self.capacity)
            alg.update(int(msg_np[0]), self.grad_size)
            self._record_wire(rank, msg_np, compact, float(res_linf))
            sp.set_attribute("wire_bytes", int(compact.size) * 4)
            if self.overlap:
                if self._pending[rank] is not None:
                    with tracing.span("apply", slice=rank):
                        self._apply_messages(rank, self._pending[rank].result())
                self._pending[rank] = self._io_pool.submit(self._exchange, rank, compact,
                                                           sp.context())
            else:
                padded = self._exchange(rank, compact)
                with tracing.span("apply", slice=rank):
                    self._apply_messages(rank, padded)
        return float(loss)

    def _apply_messages(self, rank: int, padded) -> None:
        """Decode and apply one exchanged message stack (the one update
        step of the sync, overlap and drain paths)."""
        self._step("dcn_decode_apply", rank, self.slice_params[rank], self.slice_opt[rank],
                   padded)

    def _record_wire(self, rank, msg_np, compact, res_linf):
        self._wire_tmp[rank] = {
            "encoded": int(msg_np[0]),
            "dense_bytes": self.grad_size * 4,
            "d2h_bytes": int(msg_np.size) * 4,
            "wire_bytes": int(compact.size) * 4,
            "compression": self.grad_size / max(int(compact.size), 1),
            "threshold": float(self.algorithms[rank].current()),
            "residual_linf": res_linf,
        }
        reg = get_registry()
        if self._sends:
            reg.counter("tpudl_dcn_wire_bytes_total").inc(int(compact.size) * 4)
        reg.counter("tpudl_dcn_d2h_bytes_total").inc(int(msg_np.size) * 4)
        reg.counter("tpudl_dcn_steps_total").inc()

    def _slice_step(self, rank, features, labels, fmask, lmask):
        """Host codec (the oracle): the gradient's step → the dense flat
        gradient on the host → compressed allreduce → the same apply."""
        with tracing.span("slice", parent=self._step_ctx, slice=rank, codec="host"):
            f, l, fm, lm = self._place(rank, (features, labels, fmask, lmask))
            loss, flat = self._step("dcn_grad", rank, self.slice_params[rank],
                                    self.slice_state[rank], f, l, fm, lm, self._streams[rank])
            total = self.reducers[rank].allreduce(flat.cpu().numpy())
            # slice gradients are means over the slice's sub-batch → the grand mean
            grad = torch.from_numpy(total / self.world_size).to(self.devices[rank])
            self._step("dcn_apply", rank, self.slice_params[rank], self.slice_opt[rank], grad)
            r = self.reducers[rank]
            stats = {"residual_linf": float(np.abs(r.accumulator.residual).max()),
                     **r.wire_stats(r.last_message)}
            self._wire_tmp[rank] = stats
            reg = get_registry()
            if self._sends:
                reg.counter("tpudl_dcn_wire_bytes_total").inc(stats["wire_bytes"])
            reg.counter("tpudl_dcn_steps_total").inc()
            return float(loss)

    def _seed_streams(self, rng) -> None:
        """Reseed each slice's stream from ``rng`` (an int seed or a CPU
        ``torch.Generator``): one seed per global rank, drawn on the host."""
        if isinstance(rng, torch.Generator):
            if rng.device.type != "cpu":
                raise ValueError("rng must be a CPU torch.Generator (the slices' seeds are "
                                 "drawn on the host) or an int seed")
            gen = rng
        else:
            gen = torch.Generator().manual_seed(int(rng))
        seeds = torch.randint(0, 2 ** 62, (self.world_size,), generator=gen).tolist()
        for r, stream in enumerate(self._streams):
            stream.manual_seed(seeds[self.rank_offset + r])

    def fit_batch(self, batch, rng=None) -> float:
        """One LOCAL step: the batch's leading dim splits evenly across this
        process's slices.  ``rng`` (an int seed or a CPU ``torch.Generator``)
        reseeds the slices' random streams first; without it they run on.
        Returns the mean of the slices' losses."""
        self._ensure_ready()
        faults.fire("trainer.step", index=self.iteration)
        flight_recorder.progress("trainer.step")
        n = self.n_slices
        feats, labels = batch.features, batch.labels
        # a slice of several ranks takes its share of the global batch
        shares = n if self._mesh is None else self.world_size
        first = 0 if self._mesh is None else self.rank_offset
        if feats.shape[0] % shares:
            raise ValueError(f"batch {feats.shape[0]} not divisible by {shares} slices")
        per = feats.shape[0] // shares
        fmask, lmask = _batch_masks(batch)

        def sub(v, i):
            return None if v is None else v[(first + i) * per:(first + i + 1) * per]

        if rng is not None:
            self._seed_streams(rng)
        step = self._slice_step_device if self.device_encode else self._slice_step
        self._wire_tmp = [None] * n
        step_t0 = time.perf_counter()
        with tracing.span("step", iteration=self.iteration, slices=n) as sp:
            # slice spans run on pool threads, where the ambient context does
            # not reach: they get this step span's context explicitly
            self._step_ctx = sp.context()
            futures = [self._pool.submit(step, i, sub(feats, i), sub(labels, i), sub(fmask, i),
                                         sub(lmask, i)) for i in range(n)]
            losses = [f.result() for f in futures]
            mean_loss = float(np.mean(losses))
            sp.set_attribute("score", mean_loss)
        self.last_wire_stats = list(self._wire_tmp)
        flight_recorder.progress("trainer.step")
        flight_recorder.record("step", iteration=self.iteration, slices=n, score=mean_loss)
        # this worker's progress onto the coordinator's dashboard (a buffer
        # append; no network on this path)
        obs_remote.notify_step(self.iteration, duration_s=time.perf_counter() - step_t0,
                               score=mean_loss, slices=n)
        self.bus.dispatch("iteration_done", self.net, self.iteration, 0, mean_loss)
        self.iteration += 1
        return mean_loss

    def fit(self, iterator, epochs: int = 1):
        """``epochs`` passes over ``iterator`` (reset before each); each
        batch's streams are reseeded from one host generator seeded with
        the config's seed.  Drains the last overlapped exchange."""
        self._ensure_ready()
        gen = torch.Generator().manual_seed(int(getattr(self.net.conf, "seed", 0) or 0))
        last = float("nan")
        with tracing.span("fit", model=type(self.net).__name__, slices=self.n_slices,
                          world_size=self.world_size, epochs=epochs):
            self.bus.dispatch("on_fit_start", self.net)
            for epoch in range(epochs):
                with tracing.span("epoch", epoch=epoch):
                    if hasattr(iterator, "reset"):
                        iterator.reset()
                    for batch in iterator:
                        last = self.fit_batch(batch, gen)
            self.finish()
            self.bus.dispatch("on_fit_end", self.net)
        return last

    def finish(self):
        """Drain the in-flight overlapped exchanges (apply the last pending
        totals); nothing to do in synchronous mode."""
        for rank in range(self.n_slices):
            if self._pending[rank] is not None:
                self._apply_messages(rank, self._pending[rank].result())
                self._pending[rank] = None
                get_registry().counter("tpudl_dcn_drained_exchanges_total").inc()

    # ---------------------------------------------------------- sync back
    def collect(self, average_state: bool = True):
        """Write the trained params, state and updater state back onto the
        net (SharedTrainingMaster's "collect the trained model").  Params
        and updater state need no averaging (the slices apply the same
        totals); layer statistics are per-slice sub-batch estimates and are
        averaged here, in f32, in slice order."""
        self.finish()
        dev = self.net.device
        self.net.params_ = _copy_tree(self.slice_params[0], dev)
        if average_state and self.n_slices > 1:
            def avg(*xs):
                if not (torch.is_tensor(xs[0]) and xs[0].is_floating_point()):
                    return xs[0].detach().to(dev, copy=True) if torch.is_tensor(xs[0]) else xs[0]
                acc = xs[0].detach().to(dev, torch.float32, copy=True)
                for x in xs[1:]:
                    acc = acc + x.detach().to(dev, torch.float32)
                return (acc / len(xs)).to(xs[0].dtype)

            self.net.state_ = tree_map(avg, *self.slice_state)
        else:
            self.net.state_ = _copy_tree(self.slice_state[0], dev)
        self.net.opt_state = _copy_tree(self.slice_opt[0], dev)
        return self.net

    # -------------------------------------------------- codec-state serde
    def codec_state(self) -> list[dict]:
        """Per local slice, the codec state (residual and adaptive τ) for a
        checkpoint: restoring it makes a restarted run continue the
        interrupted one bit for bit."""
        self.finish()
        if self.device_encode:
            return [{"residual": self.slice_residual[r][0].to("cpu", copy=True).numpy(),
                     "threshold": self.algorithms[r].current()} for r in range(self.n_slices)]
        return [{"residual": self.reducers[r].accumulator.residual.copy(),
                 "threshold": self.reducers[r].accumulator.algorithm.current()}
                for r in range(self.n_slices)]

    def load_codec_state(self, states: Sequence[dict]) -> None:
        for r, st in enumerate(states):
            if self.device_encode:
                with torch.no_grad():
                    self.slice_residual[r][0].copy_(
                        torch.from_numpy(np.asarray(st["residual"], np.float32)))
                self.algorithms[r]._threshold = float(st["threshold"])
            else:
                acc = self.reducers[r].accumulator
                acc.residual[:] = np.asarray(st["residual"], np.float32)
                acc.algorithm._threshold = float(st["threshold"])

    def max_param_divergence(self) -> float:
        """L∞ distance between slice replicas (0.0: byte-synchronized),
        computed on the first slice's device.  With slices of several
        ranks, collective: every rank's params against global rank 0's
        (a broadcast and a max all-reduce over the group)."""
        dev = self.devices[0]
        flats = [flat_param_vector(p).to(dev) for p in self.slice_params]
        if self._mesh is not None:
            import torch.distributed as dist
            ref = flats[0].clone()
            dist.broadcast(ref, src=0)
            gap = (flats[0] - ref).abs().max().reshape(1).to(torch.float64)
            dist.all_reduce(gap, op=dist.ReduceOp.MAX)
            return float(gap.item())
        return float(max(((f - flats[0]).abs().max().item() for f in flats[1:]),
                         default=0.0))

    def close(self):
        # drain in-flight overlapped exchanges BEFORE the pools go, or
        # overlap mode would drop the last update
        try:
            self.finish()
        finally:
            self._pool.shutdown(wait=False)
            self._io_pool.shutdown(wait=False)
