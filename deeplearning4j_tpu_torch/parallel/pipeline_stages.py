"""Heterogeneous pipeline parallelism with a 1F1B schedule (port of
``deeplearning4j_tpu/parallel/pipeline_stages.py``).

The JAX package runs every stage in one SPMD program: ``lax.switch`` on
the device's stage index, inter-stage activations flattened and padded to
one buffer width so that ``lax.ppermute`` can pass them around a ring, and
``sent_f``/``sent_b`` flags saying which payloads were real.  The port
runs **one process per stage** (``parallel.make_mesh(pipe=S)`` over a
``torch.distributed`` group), so each rank runs only its own stage, and
every hop is a point-to-point message on the pipe axis's group:

- the schedule is a table ``(F, B)`` of ``[T, S]`` microbatch indices
  (``-1``: idle) that every rank computes alike
  (:func:`make_1f1b_schedule`, :func:`make_gpipe_schedule`, plain numpy,
  the JAX package's);
- in each tick a rank posts the receives the table says will arrive (an
  activation from the stage below, a cotangent from the stage above),
  runs its forward or backward op, posts its activation send up or its
  cotangent send down, and only then waits, so no pair of ranks
  deadlocks; a stage that does nothing in a tick sends nothing;
- each hop carries the tensor as it is (no padding to a uniform width):
  the first activation a link carries in a step is preceded by its shape
  and dtype;
- gloo moves host tensors only, so a CUDA activation or cotangent goes
  through page-locked host buffers (``parallel.unified``'s staging; the
  ``"pipe"`` entry of ``unified.reset_exchange_stats`` counts the hops,
  their bytes and host seconds).

A forward tick runs the stage without autograd and stashes its input; the
backward tick **recomputes** the stage forward from the stash under
autograd (the JAX package's remat), so a stage holds at most ``S - s``
inputs under 1F1B and ``M`` under GPipe.  The last stage's forward tick
computes nothing: its backward tick runs the stage with the loss attached.
With a random stream (``rng``, a ``torch.Generator``) each forward starts
from the state the stage below handed up with the activation (stage 0:
its own stream, microbatch after microbatch), the backward recompute
restarts from that state, so it draws the forward's dropout masks, and
every rank ends the step with the last stage's final state: at one
microbatch the stages draw what the single-process step draws.

The collectives and exchanges are ``torch.distributed``'s: no TPU kernel
stands behind the schedule (the JAX package's is ``lax`` ops); the stage
functions run whatever kernels their layers run.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.mesh import AXIS_PIPE
from deeplearning4j_tpu_torch.parallel.unified import MODEL_AXIS_ITEM, _Axis, _count
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map


# ------------------------------------------------------------- scheduling
def make_1f1b_schedule(n_stages: int, n_micro: int):
    """Simulate non-interleaved 1F1B (PipeDream-flush).  Returns (F, B):
    int arrays [T, S]; entry = microbatch index or -1 (idle).

    Verifies the single-slot-buffer invariant (an arriving activation /
    cotangent is always consumed before the next one lands) and the
    in-flight bound (stage s stashes ≤ S - s inputs)."""
    S, M = n_stages, n_micro
    INF = 10 ** 9
    arr_f = [[0] * M if s == 0 else [INF] * M for s in range(S)]
    arr_b = [[INF] * M for s in range(S)]
    f_next, b_next = [0] * S, [0] * S
    F_rows, B_rows = [], []
    t = 0
    while any(b_next[s] < M for s in range(S)) and t < 4 * (S + M):
        F_row, B_row = [-1] * S, [-1] * S
        for s in range(S):
            in_flight = f_next[s] - b_next[s]
            limit = S - s                      # 1F1B in-flight cap
            if (f_next[s] < M and in_flight < limit
                    and arr_f[s][f_next[s]] <= t):
                m = f_next[s]
                F_row[s] = m
                f_next[s] += 1
                if s + 1 < S:
                    arr_f[s + 1][m] = t + 1    # activation arrives next tick
                else:
                    arr_b[s][m] = t + 1        # loss seed ready next tick
            elif b_next[s] < M and arr_b[s][b_next[s]] <= t:
                m = b_next[s]
                B_row[s] = m
                b_next[s] += 1
                if s > 0:
                    arr_b[s - 1][m] = t + 1    # cotangent arrives next tick
        F_rows.append(F_row)
        B_rows.append(B_row)
        t += 1
    assert all(b_next[s] == M for s in range(S)), "schedule did not drain"
    F = np.asarray(F_rows, np.int32)
    B = np.asarray(B_rows, np.int32)
    _verify_single_slot(F, B, S, M)
    return F, B


def _verify_single_slot(F, B, S, M):
    """Every arrival is consumed before the next lands (one forward slot
    and one backward slot per stage)."""
    for s in range(1, S):
        pending = None
        for t in range(F.shape[0]):
            if t > 0 and F[t - 1, s - 1] >= 0:        # arrival from below
                assert pending is None, f"fwd buffer overrun at stage {s}"
                pending = int(F[t - 1, s - 1])
            if F[t, s] >= 0:
                assert pending == int(F[t, s]), "fwd order violated"
                pending = None
    for s in range(S - 1):
        pending = None
        for t in range(B.shape[0]):
            if t > 0 and B[t - 1, s + 1] >= 0:
                assert pending is None, f"bwd buffer overrun at stage {s}"
                pending = int(B[t - 1, s + 1])
            if B[t, s] >= 0:
                assert pending == int(B[t, s]), "bwd order violated"
                pending = None


def make_gpipe_schedule(n_stages: int, n_micro: int):
    """All-forward-then-all-backward schedule in the same table format
    (for memory comparison against 1F1B; stash depth becomes M)."""
    S, M = n_stages, n_micro
    T = S + M - 1
    F = -np.ones((2 * T, S), np.int32)
    B = -np.ones((2 * T, S), np.int32)
    for m in range(M):
        for s in range(S):
            F[m + s, s] = m
    for m in range(M):
        for s in reversed(range(S)):
            B[T + m + (S - 1 - s), s] = m
    return F, B


def _schedule(schedule: str, S: int, M: int):
    if schedule == "1f1b":
        return make_1f1b_schedule(S, M)
    if schedule == "gpipe":
        return make_gpipe_schedule(S, M)
    raise ValueError(f"unknown schedule {schedule!r}")


# ------------------------------------------------------------- the links
# a header's dtypes, by code
_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int32,
           torch.int64, torch.uint8, torch.bool)
_HEADER = 10            # code, ndim, up to 8 dims
_TAG_ACT, _TAG_HEADER, _TAG_CT, _TAG_RNG = 1, 2, 3, 4


def _header(t: torch.Tensor) -> torch.Tensor:
    if t.ndim > _HEADER - 2:
        raise ValueError(f"a pipeline hop carries at most {_HEADER - 2} dims, got {t.ndim}")
    return torch.tensor([_DTYPES.index(t.dtype), t.ndim] + list(t.shape)
                        + [0] * (_HEADER - 2 - t.ndim), dtype=torch.int64)


def _from_header(h: torch.Tensor) -> tuple:
    code, ndim = int(h[0]), int(h[1])
    return tuple(int(d) for d in h[2:2 + ndim]), _DTYPES[code]


class _Tick:
    """One rank's exchanges of one tick along the pipe axis: posted sends
    and receives (host buffers, page-locked for a CUDA tensor), waited for
    together by :meth:`wait`, which returns what arrived on the device.
    The ``"pipe"`` exchange counts get each hop's bytes and the host
    seconds of staging, posting and waiting."""

    def __init__(self, axis: _Axis, device: torch.device):
        self.axis, self.device = axis, device
        self.reqs, self.keep, self.arrivals = [], [], []
        self.sent = self.staged = 0
        self.seconds = 0.0

    def send(self, t: torch.Tensor, to: int, tag: int) -> None:
        import torch.distributed as dist
        t0 = time.perf_counter()
        host, staged = self.axis._to_host(t.detach())
        self.reqs.append(dist.isend(host, self.axis.ranks[to], group=self.axis.group, tag=tag))
        self.keep.append(host)
        self.sent += host.numel() * host.element_size()
        self.staged += staged
        self.seconds += time.perf_counter() - t0

    def recv(self, shape, dtype, frm: int, tag: int, on_device: bool = True) -> int:
        """Post a receive; its tensor is ``wait()[index]``."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        pinned = on_device and self.device.type == "cuda"
        host = torch.empty(shape, dtype=dtype, pin_memory=pinned)
        self.reqs.append(dist.irecv(host, self.axis.ranks[frm], group=self.axis.group, tag=tag))
        self.arrivals.append((host, on_device))
        self.seconds += time.perf_counter() - t0
        return len(self.arrivals) - 1

    def wait(self) -> list:
        t0 = time.perf_counter()
        for r in self.reqs:
            r.wait()
        out = []
        for host, on_device in self.arrivals:
            if on_device and self.device.type != "cpu":
                out.append(host.to(self.device))
                self.staged += host.numel() * host.element_size()
            else:
                out.append(host)
        self.seconds += time.perf_counter() - t0
        if self.reqs:
            _count("pipe", self.sent, self.staged, self.seconds)
        return out


def _broadcast(t: torch.Tensor, src: int, axis: _Axis) -> torch.Tensor:
    """``t`` from the axis position ``src`` to every position (in place on
    the receivers), counted as a ``"pipe_collective"`` exchange."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.broadcast(t, src=axis.ranks[src], group=axis.group)
    _count("pipe_collective", t.numel() * t.element_size(), 0, time.perf_counter() - t0)
    return t


def _broadcast_tensor(t: Optional[torch.Tensor], src: int, axis: _Axis,
                      device: torch.device) -> torch.Tensor:
    """A tensor of any shape from position ``src`` to every position (its
    header first)."""
    header = _header(t) if axis.index == src else torch.zeros(_HEADER, dtype=torch.int64)
    shape, dtype = _from_header(_broadcast(header, src, axis))
    if axis.index != src:
        t = torch.empty(shape, dtype=dtype, device=device)
    return _broadcast(t.contiguous(), src, axis)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


# ------------------------------------------------------- the schedule run
def _call(fn, p, h, gen):
    return fn(p, h) if gen is None else fn(p, h, gen)


def _run_schedule(axis: _Axis, F, B, fwd: Callable, bwd: Optional[Callable], micro_x, gen,
                  device) -> list:
    """Run this rank's column of the schedule ``(F, B)`` (module
    docstring).  ``fwd(h)`` is the stage's forward without autograd
    (stages below the last); ``bwd(m, h, ct)`` the backward tick: the
    stage recomputed from its input ``h`` under autograd with the
    cotangent ``ct`` of its output (None on the last stage), returning the
    cotangent of ``h`` (None on stage 0).  ``micro_x[m]`` is stage 0's
    input.  With ``gen`` every rank ends with the last stage's final
    state.  ``bwd`` None runs a forward-only schedule: nothing is
    stashed, the last stage runs ``fwd`` too, and its outputs come back
    in microbatch order (an empty list below the last stage)."""
    s, S = axis.index, axis.n
    M = int(F.max()) + 1
    acts, cts, rngs = {}, {}, {}          # what arrived, by microbatch
    stash = {}                            # m -> (the stage's input, the stream's state)
    in_shape = out_shape = None           # (shape, dtype) of the stage's input and output
    chain = gen.get_state() if gen is not None else None
    last_state = None
    outs = []
    for t in range(F.shape[0]):
        f_mb, b_mb = int(F[t, s]), int(B[t, s])
        tick = _Tick(axis, device)
        expect, late = [], None
        if s > 0 and F[t, s - 1] >= 0:
            m = int(F[t, s - 1])
            if in_shape is None:         # the link's first activation: its header first
                late = (m, tick.recv((_HEADER,), torch.int64, s - 1, _TAG_HEADER,
                                     on_device=False))
            else:
                expect.append((acts, m, tick.recv(*in_shape, s - 1, _TAG_ACT)))
            if gen is not None:
                expect.append((rngs, m, tick.recv(chain.shape, chain.dtype, s - 1, _TAG_RNG,
                                                  on_device=False)))
        if s < S - 1 and B[t, s + 1] >= 0:
            expect.append((cts, int(B[t, s + 1]), tick.recv(*out_shape, s + 1, _TAG_CT)))
        if f_mb >= 0:
            h = micro_x[f_mb] if s == 0 else acts.pop(f_mb)
            state = None if gen is None else (chain if s == 0 else rngs.pop(f_mb))
            if bwd is not None:
                stash[f_mb] = (h, state)
            # the training schedule's last stage computes nothing in a forward tick
            if s < S - 1 or bwd is None:
                if gen is not None:
                    gen.set_state(state)
                with torch.no_grad():
                    y = fwd(h)
                if s == S - 1:
                    outs.append(y)
                else:
                    if out_shape is None:
                        out_shape = (tuple(y.shape), y.dtype)
                        tick.send(_header(y), s + 1, _TAG_HEADER)
                    tick.send(y, s + 1, _TAG_ACT)
                    if gen is not None:
                        if s == 0:
                            chain = gen.get_state()
                        tick.send(gen.get_state(), s + 1, _TAG_RNG)
        if b_mb >= 0:
            h, state = stash.pop(b_mb)
            if gen is not None:
                gen.set_state(state)
            gh = bwd(b_mb, h, cts.pop(b_mb, None))
            if gen is not None and s == S - 1:
                if s == 0:
                    chain = gen.get_state()
                if b_mb == M - 1:
                    last_state = gen.get_state()
            if s > 0:
                tick.send(gh, s - 1, _TAG_CT)
        got = tick.wait()
        for store, m, i in expect:
            store[m] = got[i]
        if late is not None:
            m, i = late
            in_shape = _from_header(got[i])
            tick = _Tick(axis, device)
            j = tick.recv(*in_shape, s - 1, _TAG_ACT)
            acts[m] = tick.wait()[j]
    if gen is not None and S > 1:
        state = last_state if s == S - 1 else torch.empty_like(chain)
        gen.set_state(_broadcast(state, S - 1, axis))
    return outs


def _stage_bwd(fn, params, last: bool, first: bool, gen, head=None):
    """A stage's backward tick over the param tree ``params`` and the
    gradient accumulators it returns beside it: ``(bwd, acc, loss)``,
    ``acc`` one tensor per leaf (``tree_leaves`` order) in at least f32,
    ``loss[0]`` the sum of the microbatches' losses (last stage)."""
    leaves = tree_leaves(params)
    acc = [torch.zeros_like(p, dtype=_acc_dtype(p)) for p in leaves]
    loss = [None]

    def bwd(m, h, ct):
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            it = iter(live)
            tree = tree_map(lambda _: next(it), params)
            hin = h if first else h.detach().requires_grad_(True)
            wrt = live if first else live + [hin]
            if last:
                out = head(m, tree, hin)
                grads = torch.autograd.grad(out, wrt, allow_unused=True)
                value = out.detach()
                loss[0] = value if loss[0] is None else loss[0] + value
            else:
                y = _call(fn, tree, hin, gen)
                grads = torch.autograd.grad(y, wrt, grad_outputs=ct.to(y.dtype),
                                            allow_unused=True)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
        return None if first else grads[-1]

    return bwd, acc, loss


def _micro(a, M: int):
    """``a`` [M·bm, ...] as M contiguous microbatches."""
    return a.reshape((M, a.shape[0] // M) + tuple(a.shape[1:]))


def _flat(tensors) -> torch.Tensor:
    """The tensors raveled and concatenated, in the widest of their dtypes."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _unflat(flat: torch.Tensor, likes) -> list:
    out, offset = [], 0
    for like in likes:
        out.append(flat[offset:offset + like.numel()].view(like.shape).to(like.dtype))
        offset += like.numel()
    return out


def _pipe_axis(mesh, axis: str, n_fns: int, model_axis=None) -> _Axis:
    if model_axis is not None:
        raise NotImplementedError(f"model_axis={model_axis!r}: a pipeline over the model axis "
                                  f"(pipe x model) is not ported yet; {MODEL_AXIS_ITEM} ports it")
    pipe = _Axis(mesh, axis)
    if n_fns != pipe.n:
        raise ValueError(f"{n_fns} stage fns for {pipe.n}-way '{axis}' axis")
    return pipe


# ---------------------------------------------------------- the train step
def pipeline_train_step(stage_fns: Sequence[Callable], stage_params, x, labels, loss_fn, mesh,
                        n_microbatches: int, axis: str = AXIS_PIPE, schedule: str = "1f1b",
                        data_axis: Optional[str] = None, model_axis: Optional[str] = None,
                        rng: Optional[torch.Generator] = None,
                        head_loss: Optional[Callable] = None, param_specs=None,
                        boundary_shapes=None):
    """One pipelined training step over heterogeneous stages, on this
    rank's stage of ``mesh``'s ``axis`` (every rank of the pipe group
    calls it together; module docstring).

    - ``stage_fns[i](params_i, h) -> h'``: any per-stage param trees and
      activation shapes (batch dim kept); with ``rng`` (a
      ``torch.Generator``, the same state on every rank) the convention
      is ``stage_fns[i](params_i, h, rng)``.
    - ``stage_params``: the tuple of every stage's trees (the JAX
      package's replicated operand); this rank runs entry ``index`` of
      the pipe axis and reads the others' shapes only.
    - ``x``, ``labels``: this rank's batch (its data position's rows
      under ``data_axis``), split into ``n_microbatches`` contiguous
      microbatches; stage 0 reads ``x``, the last stage ``labels``.
    - ``loss_fn(y, labels_mb) -> scalar`` on the last stage per
      microbatch, or ``head_loss(params_last, h, labels_mb[, rng])``,
      the loss from the last stage's params and input.
    - ``data_axis``: DP x PP: loss and gradients averaged over the data
      group, each data position running the schedule on its rows.
    - ``model_axis`` (TP x PP) raises ``NotImplementedError`` naming
      ``ROADMAP.md`` queue A item 2.5; ``param_specs`` and
      ``boundary_shapes`` are the JAX package's sharding and shape
      hints, which one process per stage does not need.

    Returns ``(loss, grads)`` as the JAX package does: the mean loss over
    the microbatches and the tuple of every stage's gradient trees (the
    mean over microbatches, each leaf in at least f32), the same on every
    rank of the pipe group.  ``schedule='1f1b'`` stashes at most ``S -
    s`` stage inputs; ``'gpipe'`` runs all forwards first (``M`` deep)."""
    pipe = _pipe_axis(mesh, axis, len(stage_fns), model_axis)
    if boundary_shapes is not None and len(boundary_shapes) != pipe.n:
        raise ValueError(f"{len(boundary_shapes)} boundary shapes for {pipe.n} stages")
    data = _Axis(mesh, data_axis) if data_axis is not None else None
    S, s, M = pipe.n, pipe.index, n_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches={M} (this rank's "
                         f"rows)")
    F, B = _schedule(schedule, S, M)
    micro_x, micro_y = _micro(x, M), _micro(labels, M)
    gen = rng
    fn, params = stage_fns[s], stage_params[s]

    def head(m, tree, h):
        if head_loss is not None:
            return head_loss(tree, h, micro_y[m]) if gen is None else \
                head_loss(tree, h, micro_y[m], gen)
        return loss_fn(_call(fn, tree, h, gen), micro_y[m])

    bwd, acc, loss = _stage_bwd(fn, params, s == S - 1, s == 0, gen, head)
    _run_schedule(pipe, F, B, lambda h: _call(fn, params, h, gen), bwd, micro_x, gen, x.device)
    own = [a / M for a in acc]
    if s == S - 1:
        mean_loss = loss[0] / M
    else:
        mean_loss = torch.zeros((), dtype=_acc_dtype(x), device=x.device)
    if data is not None and data.n > 1:
        # each data position saw an equal shard: the mean of their means
        import torch.distributed as dist
        flat = _flat(own + [mean_loss.reshape(1)])
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=data.group)
        _count("pipe_collective", flat.numel() * flat.element_size(), 0,
               time.perf_counter() - t0)
        parts = _unflat(flat / data.n, own + [mean_loss.reshape(1)])
        own, mean_loss = parts[:-1], parts[-1].reshape(())
    # every stage's gradients to every rank (the JAX package's psum over pipe)
    grads = []
    for j in range(S):
        likes = own if j == s else [torch.zeros_like(p, dtype=_acc_dtype(p))
                                    for p in tree_leaves(stage_params[j])]
        flat = _broadcast(_flat(likes), j, pipe) if S > 1 else _flat(likes)
        it = iter(_unflat(flat, likes))
        grads.append(tree_map(lambda _: next(it), stage_params[j]))
    if S > 1:
        mean_loss = _broadcast_tensor(mean_loss if s == S - 1 else None, S - 1, pipe, x.device)
    return mean_loss, tuple(grads)


# ------------------------------------------------- stage-local optimizer
def flatten_stage_params(stage_params):
    """Per-stage trees → (an [S, Pmax] f32 buffer, the unravel functions,
    the sizes): each stage's leaves raveled in ``jax.flatten_util.
    ravel_pytree``'s order (``utils/pytree.py``), zero-padded to the
    widest stage.  A rank of a pipe layout keeps its own row
    (:func:`stage_row`); padding stays zero under any elementwise
    updater."""
    from deeplearning4j_tpu_torch.utils.pytree import flat_param_vector, unflatten_param_vector
    flats, unravels, sizes = [], [], []
    for p in stage_params:
        f = flat_param_vector(p).to(torch.float32)
        flats.append(f)
        sizes.append(int(f.numel()))
        unravels.append(lambda row, like=p: unflatten_param_vector(row, like))
    pmax = max(sizes)
    stacked = torch.stack([torch.nn.functional.pad(f, (0, pmax - f.numel())) for f in flats])
    return stacked, unravels, sizes


def unflatten_stage_params(params_flat, unravels, sizes):
    """[S, Pmax] buffer → tuple of per-stage trees."""
    return tuple(u(params_flat[i, :n]) for i, (u, n) in enumerate(zip(unravels, sizes)))


def stage_row(params_flat, mesh, axis: str = AXIS_PIPE):
    """This rank's block ``[1, Pmax]`` of an ``[S, Pmax]`` buffer (the
    JAX package's ``P(axis)`` shard); a ``[1, Pmax]`` block as it is."""
    if params_flat.shape[0] == 1:
        return params_flat
    s = _Axis(mesh, axis).index
    return params_flat[s:s + 1]


def init_stage_local_opt(tx, params_flat, mesh, axis: str = AXIS_PIPE):
    """The updater state of this rank's row of the ``[S, Pmax]`` buffer
    (``tx``: a ``train.updaters`` updater or ``Optimizer``): the JAX
    package's stage-sharded optimizer state, each rank holding its
    stage's."""
    return tx.init(stage_row(params_flat, mesh, axis).clone())


def pipeline_fit_step_local(stage_fns: Sequence[Callable], params_flat, opt_state, tx,
                            unravels, sizes, x, labels, loss_fn, mesh, n_microbatches: int,
                            axis: str = AXIS_PIPE, schedule: str = "1f1b"):
    """The 1F1B step with stage-local gradients and optimizer: this rank
    keeps its stage's flat row (``params_flat``: its ``[1, Pmax]`` block,
    or the whole ``[S, Pmax]`` buffer, of which it takes its row), its
    one ``[Pmax]`` gradient and its updater state (``opt_state`` from
    :func:`init_stage_local_opt`), and only the loss crosses the pipe
    group.  ``tx`` must be elementwise (sgd, momentum, adam, ...): a
    cross-parameter transform would see one stage's slice.  Returns
    ``(loss, new row block [1, Pmax], new updater state)``."""
    pipe = _pipe_axis(mesh, axis, len(stage_fns))
    S, s, M = pipe.n, pipe.index, n_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by {M} microbatches")
    F, B = _schedule(schedule, S, M)
    row = stage_row(params_flat, mesh, axis)
    fn, size = stage_fns[s], sizes[s]
    micro_x, micro_y = _micro(x, M), _micro(labels, M)

    def head(m, tree, h):
        return loss_fn(fn(tree, h), micro_y[m])

    def as_tree(r):
        return unravels[s](r[0, :size])

    # the backward differentiates the row itself: its gradient is flat,
    # zero in the padding
    bwd_tree, acc, loss = _stage_bwd(lambda r, h: fn(as_tree(r), h), row, s == S - 1, s == 0,
                                     None, lambda m, r, h: head(m, as_tree(r), h))
    with torch.no_grad():
        tree = as_tree(row)
    _run_schedule(pipe, F, B, lambda h: fn(tree, h), bwd_tree, micro_x, None, x.device)
    grads = acc[0] / M
    mean_loss = loss[0] / M if s == S - 1 else None
    if S > 1:
        mean_loss = _broadcast_tensor(mean_loss, S - 1, pipe, x.device)
    with torch.no_grad():
        updates, new_opt = tx.update(grads, opt_state, row)
        new_row = row + updates
    return mean_loss, new_row, new_opt


# ------------------------------------------------------- forward only
def pipeline_apply_stages(stage_fns: Sequence[Callable], stage_params, x, mesh,
                          n_microbatches: int, axis: str = AXIS_PIPE):
    """Forward-only heterogeneous pipeline (GPipe fill-drain): per-stage
    trees and widths, this rank's stage run on each microbatch as it
    arrives.  Returns the last stage's output ``[B, ...]`` on every rank
    of the pipe group (``x``: this rank's batch; stage 0 reads it)."""
    pipe = _pipe_axis(mesh, axis, len(stage_fns))
    return _fill_drain(pipe, stage_fns[pipe.index], stage_params[pipe.index], x,
                       n_microbatches)


def _fill_drain(pipe: _Axis, fn: Callable, params, x, M: int):
    """This rank's stage over the ``S + M - 1`` ticks of a forward-only
    pipeline (GPipe's forward half); the last stage's outputs,
    concatenated, broadcast to the pipe group."""
    S = pipe.n
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by {M} microbatches")
    F = make_gpipe_schedule(S, M)[0][:S + M - 1]
    outs = _run_schedule(pipe, F, np.full_like(F, -1), lambda h: fn(params, h), None,
                         _micro(x, M), None, x.device)
    y = torch.cat(outs) if pipe.index == S - 1 else None
    return _broadcast_tensor(y, S - 1, pipe, x.device) if S > 1 else y
