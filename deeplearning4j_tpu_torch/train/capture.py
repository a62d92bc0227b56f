"""Captured steps: the port's counterpart of ``jax.jit`` with donation.

The JAX package runs every training step, and the serving forward, as
one compiled program whose params, state and updater state are donated
(their buffers reused for the results).  Here a step is a plain function
``fn(*trees, *batch)``: the first ``n_trees`` arguments are trees of
tensors (nested dicts and lists) that the step updates in place, which
is the donation; the rest are batch tensors (or lists of them: a
``MultiDataSet``'s fields), ``None`` (a mask left out) or
``torch.Generator`` s (the step's random streams); it returns a tensor
or a tuple of tensors and of its own tree arguments.  On a CUDA card
:class:`CapturedStep` runs it as a ``torch.cuda.CUDAGraph`` per batch
signature (the shapes and dtypes of the batch, and which of its entries
are ``None``):

- the first ``WARMUP_CALLS`` calls of a signature run eagerly on a side
  stream: they are real steps, as the JAX package's first call both
  compiles and runs;
- the next call captures the step once (no kernel runs while capturing,
  so nothing is stepped twice) and replays it, and every later call
  replays: one graph launch in place of the step's launches;
- the trees are the graph's static buffers: the first caller's tensors
  themselves.  A caller with other trees of the same shapes (a second
  net of the same configuration) has its values copied into the buffers,
  and its tensors are made to share the buffers' memory (``Tensor.set_``)
  while the previous holder's tensors get a copy of their own, so that
  both stay right (``switches`` counts these moves);
- the batch is copied into static input buffers before each replay, on
  the caller's current stream (after whatever that stream waits on, such
  as a ``DeviceFeeder`` copy's event), outside the graph;
- each generator is registered with the graph, so every replay draws
  fresh numbers, the same as the eager step would from the generator's
  state; a generator other than the one registered has its state carried
  through the registered one for the replay and back;
- outputs that are not tree arguments are static buffers of the graph
  and come back as fresh copies, so a loss kept by the caller does not
  change on the next replay.

The graphs of one step share one memory pool.  A capture that fails
raises :class:`CaptureError` naming the step and the signature; nothing
runs eagerly in its place.  On the CPU, and inside :func:`eager`, the step
runs as the plain function.  The kernels' launch counts go up when a
step runs eagerly and once when it is captured, not on a replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

# eager calls of a batch signature before it is captured
WARMUP_CALLS = 2

_eager_depth = 0
_eager_lock = threading.Lock()
# one capture at a time in the process (CUDA graphs' own rule)
_capture_lock = threading.Lock()


@contextlib.contextmanager
def eager():
    """Every captured step, in every thread, runs as its plain function
    while this is open (the counterpart of ``jax.disable_jit``): the
    launch counts, the kernels' plain versions and a recorded dropout mask
    then see each step."""
    global _eager_depth
    with _eager_lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _eager_lock:
            _eager_depth -= 1


class CaptureError(RuntimeError):
    """Capturing a step into a CUDA graph failed."""


def write_into(dst, src) -> None:
    """Each leaf of the tree ``src`` copied into the same leaf of ``dst`` (a
    leaf that is already its destination stays): how a step writes new
    state into the tree it was given."""
    tree_map(lambda d, s: d if d is s else d.copy_(s), dst, src)


def _batch_signature(args) -> tuple:
    sig = []
    for a in args:
        if a is None:
            sig.append(None)
        elif torch.is_tensor(a):
            sig.append((tuple(a.shape), a.dtype, a.device))
        elif isinstance(a, torch.Generator):
            sig.append(("generator", a.device))
        elif isinstance(a, (list, tuple)) and all(x is None or torch.is_tensor(x) for x in a):
            sig.append(("list",) + _batch_signature(a))
        else:
            raise TypeError(f"a captured step takes tensors (or lists of them), None or "
                            f"torch.Generator after its trees, got {type(a).__name__}")
    return tuple(sig)


def _static_copy(a):
    """A batch argument's static buffer: a clone of a tensor (of each
    tensor of a list); anything else as it is."""
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, (list, tuple)):
        return [_static_copy(x) for x in a]
    return a


def _copy_into(buf, a) -> None:
    if torch.is_tensor(buf):
        buf.copy_(a)
    elif isinstance(buf, list):
        for b, x in zip(buf, a):
            _copy_into(b, x)


def _tree_signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


@dataclasses.dataclass
class _Graph:
    graph: Any                 # torch.cuda.CUDAGraph
    static: list               # the batch's static input buffers (None, generators as given)
    outputs: list              # per output: the index of a tree argument, or a static tensor
    generators: tuple          # the generators registered with the graph
    is_tuple: bool


@dataclasses.dataclass
class _Binding:
    """The static buffers of one tree signature and the graphs that read
    them; ``holder`` are the caller-side tensors sharing their memory."""
    buffers: list
    holder: list
    graphs: dict = dataclasses.field(default_factory=dict)


class CapturedStep:
    """``fn`` run as CUDA graphs on the card (module docstring); ``name``
    labels it in errors (the step cache passes its key)."""

    def __init__(self, fn: Callable, n_trees: int, name: Any = ""):
        self.fn = fn
        self.n_trees = n_trees
        self.name = name
        self._bindings: dict[tuple, _Binding] = {}
        self._warm: dict[tuple, int] = {}
        self._pool = None
        self._side: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()
        self.calls = 0          # every call, eager, captured or replayed
        self.switches = 0       # replays that first moved other trees into the buffers

    @property
    def graph_count(self) -> int:
        """How many graphs this step has captured."""
        return sum(len(b.graphs) for b in self._bindings.values())

    def __call__(self, *args):
        self.calls += 1
        leaves = [leaf for tree in args[:self.n_trees] for leaf in tree_leaves(tree)]
        if _eager_depth or not (leaves and torch.is_tensor(leaves[0])
                                and leaves[0].device.type == "cuda"):
            return self.fn(*args)
        rest = args[self.n_trees:]
        batch_sig = _batch_signature(rest)
        with self._lock:
            binding = next((b for b in self._bindings.values() if _same(b.holder, leaves)), None)
            if binding is not None and batch_sig in binding.graphs:
                return self._replay(binding.graphs[batch_sig], args)
            tree_sig = _tree_signature(leaves)
            binding = self._bindings.get(tree_sig)
            if binding is None or batch_sig not in binding.graphs:
                warm = self._warm.get((tree_sig, batch_sig), 0)
                if warm < WARMUP_CALLS:
                    self._warm[(tree_sig, batch_sig)] = warm + 1
                    return self._side_stream_call(args)
            if binding is None:
                binding = self._bindings[tree_sig] = _Binding(
                    [leaf.detach() for leaf in leaves], list(leaves))
            else:
                self._adopt(binding, leaves)
                self.switches += 1
            if batch_sig not in binding.graphs:
                binding.graphs[batch_sig] = self._capture(args, batch_sig)
            return self._replay(binding.graphs[batch_sig], args)

    def _side_stream_call(self, args):
        if self._side is None:
            self._side = torch.cuda.Stream()
        current = torch.cuda.current_stream()
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            out = self.fn(*args)
        current.wait_stream(self._side)
        return out

    @staticmethod
    def _adopt(binding: _Binding, leaves: list) -> None:
        """Make ``leaves`` the tensors that share the buffers' memory, with
        their values; the previous holder keeps its values in memory of
        its own."""
        with torch.no_grad(), torch.inference_mode(False):
            for held, buf in zip(binding.holder, binding.buffers):
                if held.data_ptr() == buf.data_ptr():
                    held.set_(held.clone())
            for leaf, buf in zip(leaves, binding.buffers):
                buf.copy_(leaf)
                leaf.set_(buf)
        binding.holder = list(leaves)

    def _capture(self, args, batch_sig) -> _Graph:
        trees, rest = args[:self.n_trees], args[self.n_trees:]
        with torch.no_grad(), torch.inference_mode(False):
            static = [_static_copy(a) for a in rest]
        generators = tuple(a for a in rest if isinstance(a, torch.Generator))
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with _capture_lock:
            try:
                with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                    out = self.fn(*trees, *static)
            except Exception as e:
                raise CaptureError(f"capturing step {self.name!r} for batch signature "
                                   f"{batch_sig} failed: {type(e).__name__}: {e}") from e
        is_tuple = isinstance(out, tuple)
        outputs = []
        for o in (out if is_tuple else (out,)):
            index = next((i for i, t in enumerate(trees) if o is t), None)
            if index is None and not torch.is_tensor(o):
                raise CaptureError(f"step {self.name!r} returned a {type(o).__name__}: a "
                                   f"captured step returns tensors and its own trees")
            outputs.append(o if index is None else index)
        return _Graph(graph, static, outputs, generators, is_tuple)

    def _copy_in(self, static: list, rest) -> None:
        """The batch into the graph's static input buffers, on the
        current stream."""
        with torch.no_grad():
            for buf, a in zip(static, rest):
                _copy_into(buf, a)

    def _replay(self, g: _Graph, args):
        rest = args[self.n_trees:]
        self._copy_in(g.static, rest)
        carried = []
        for registered, gen in zip(g.generators, (a for a in rest
                                                  if isinstance(a, torch.Generator))):
            if gen is not registered:
                carried.append((registered, gen, registered.get_state()))
                registered.set_state(gen.get_state())
        g.graph.replay()
        for registered, gen, own in carried:
            gen.set_state(registered.get_state())
            registered.set_state(own)
        outs = tuple(args[o] if isinstance(o, int) else o.clone() for o in g.outputs)
        return outs if g.is_tuple else outs[0]


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))
