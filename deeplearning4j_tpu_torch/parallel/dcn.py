"""Compressed cross-slice gradient exchange (the transports and the
allreduce of ``deeplearning4j_tpu/parallel/dcn.py``).

Across slices (the data-center network) bandwidth is the bottleneck, so
the reference's threshold codec is the cross-slice compressor::

    per-slice gradient → residual + adaptive-threshold encode (sparse
    wire message) → transport exchange between slice leaders → decode and
    sum the peers' messages in global rank order → apply

:class:`InProcessTransport` is the ``DummyTransport`` counterpart for
slices in one process; :class:`SocketTransport` moves the same byte
payloads over TCP between slice-leader processes, as a ring all-gather
(rank r listens for r-1 and sends to r+1; messages circulate n-1 hops
with their origin tags), so that no rank relays for all.  Frames are
length-prefixed and tagged with their round, so a fast rank never takes
a stale payload, and a dead peer shows as a socket timeout at its
neighbours.  The framing and the ``bytes_sent`` accounting are the JAX
package's, so its byte bounds hold here.

:func:`make_multislice_mesh` lays a ``torch.distributed`` group of
``n_slices × data_per_slice`` processes out as the reference's
``('dcn', 'data', 'model')`` mesh: each slice is a process subgroup that
runs the dense layout (``parallel.mesh``), and its leader (data rank 0)
exchanges with the other slices' leaders (:class:`GroupTransport` over
the leaders' subgroup by default) and hands the peers' messages to the
rest of its slice (:class:`SliceRelay`).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator, threshold_decode)


# the ROADMAP.md item that ports a model axis inside a slice
_MODEL_AXIS_ITEM = ("queue A item 2.5 (the model-axis layouts: tp and dp x tp, with the TP rule "
                    "families)")


class MultiSliceMesh:
    """The port's multi-slice mesh (:func:`make_multislice_mesh`): the
    global group's ranks laid out as ``(n_slices, data_per_slice, model)``
    in the reference's reshape order, so that rank ``s·d + j`` is data rank
    ``j`` of slice ``s``.  Every rank holds every slice's subgroup handle
    (made collectively, in one order); this rank's are its slice's
    ``group`` (the dense layout's collectives), its ``relay_group`` (the
    leader's hand-out of the peers' messages, a group of its own so that
    an overlapped exchange never interleaves with the step's collectives)
    and, for every rank, the leaders' ``leader_group``."""

    axis_names = ("dcn", "data", "model")

    def __init__(self, n_slices: int, data_per_slice: int, devices, groups: list,
                 relay_groups: list, leader_group):
        import torch.distributed as dist

        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
        self.n_slices = int(n_slices)
        self.data_per_slice = int(data_per_slice)
        self.shape = {"dcn": self.n_slices, "data": self.data_per_slice, "model": 1}
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.slice_index, self.data_rank = divmod(self.rank, self.data_per_slice)
        self.is_leader = self.data_rank == 0
        self.groups = groups
        self.relay_groups = relay_groups
        self.leader_group = leader_group
        self.group = groups[self.slice_index]
        self.relay_group = relay_groups[self.slice_index]
        mine = self.slice_ranks(self.slice_index)
        self.devices = list(devices)
        # this slice's ProcessMesh: the dense layout's mesh over the slice
        self.slice_mesh = make_mesh(data=self.data_per_slice, group=self.group,
                                    devices=[self.devices[r] for r in mine])

    @property
    def device(self):
        return self.slice_mesh.device

    def slice_ranks(self, s: int) -> list[int]:
        """The global ranks of slice ``s``, data rank 0 first."""
        d = self.data_per_slice
        return list(range(s * d, (s + 1) * d))

    def leader(self, s: Optional[int] = None) -> int:
        """The global rank of slice ``s``'s leader (this rank's slice)."""
        return (self.slice_index if s is None else s) * self.data_per_slice

    def position(self, rank: Optional[int] = None) -> tuple[int, int, int]:
        """``(slice, data rank, model rank)`` of a global rank (this one):
        its index in the reference's ``mesh.devices``."""
        s, j = divmod(self.rank if rank is None else rank, self.data_per_slice)
        return s, j, 0

    def layout(self):
        """This slice's dense data-parallel ``MeshLayout``."""
        from deeplearning4j_tpu_torch.parallel.mesh import MeshLayout, MeshSpec
        return MeshLayout(MeshSpec(data=self.data_per_slice), mesh=self.slice_mesh)

    def transport(self) -> "GroupTransport":
        """The leaders' exchange over ``leader_group`` (a leader's; the
        other ranks take part through :class:`SliceRelay`)."""
        return GroupTransport(self.slice_index, self.n_slices, self.leader_group)

    def __repr__(self) -> str:
        return (f"MultiSliceMesh({self.shape}, rank {self.rank}: slice {self.slice_index}, data "
                f"rank {self.data_rank}{', leader' if self.is_leader else ''})")


def make_multislice_mesh(n_slices: int, data_per_slice: int, model: int = 1,
                         devices: Optional[Sequence] = None) -> MultiSliceMesh:
    """The mesh with a leading ``dcn`` axis across slices and the dense
    axes within one, ``('dcn', 'data', 'model')``, over the initialized
    global ``torch.distributed`` group of ``n_slices × data_per_slice``
    processes (:class:`MultiSliceMesh`; ``parallel.launcher`` starts them).
    Every rank must call it, in the same order as the others.  ``devices``
    is each rank's device: one for all (``"cuda"``: the ranks share the
    card) or one per rank; the card by default.  Fewer ranks than the mesh
    needs raise the reference's ``ValueError``; ``model > 1``
    ``NotImplementedError``."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.config import DEFAULT_DEVICE, resolve_device
    if model > 1:
        raise NotImplementedError(
            f"make_multislice_mesh(model={model}): a model axis inside a slice is not ported "
            f"yet; ROADMAP.md {_MODEL_AXIS_ITEM} ports it")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a multi-slice mesh needs an initialized torch.distributed process group of "
            "n_slices x data_per_slice processes: start them with "
            "parallel.launcher.spawn_local_cluster, or call "
            "parallel.launcher.initialize(address, num_processes, process_id) in each")
    need = n_slices * data_per_slice * model
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have} (the ranks of the process group)")
    if have > need:
        raise ValueError(f"the process group has {have} ranks, the mesh ({n_slices} slices x "
                         f"{data_per_slice}) takes {need}: run one process per rank")
    if devices is None:
        devices = DEFAULT_DEVICE
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * need
    devices = [resolve_device(d) for d in devices]
    if len(devices) != need:
        raise ValueError(f"{len(devices)} devices for a mesh of {need} ranks")
    d = data_per_slice
    # collective: every rank makes every subgroup, in this order
    groups = [dist.new_group(ranks=list(range(s * d, (s + 1) * d))) for s in range(n_slices)]
    relay_groups = [dist.new_group(ranks=list(range(s * d, (s + 1) * d)))
                    for s in range(n_slices)]
    leader_group = dist.new_group(ranks=[s * d for s in range(n_slices)])
    return MultiSliceMesh(n_slices, data_per_slice, devices, groups, relay_groups, leader_group)


class GroupTransport:
    """The ring transports' ``exchange`` contract over a
    ``torch.distributed`` group (the slice leaders', gloo over TCP): one
    ``all_gather_object`` of the wire messages a round."""

    def __init__(self, rank: int, n_ranks: int, group=None):
        self.rank = rank
        self.n_ranks = n_ranks
        self.group = group

    def exchange(self, rank: int, message: np.ndarray) -> list[np.ndarray]:
        import torch.distributed as dist
        if rank != self.rank:
            raise ValueError(f"transport bound to rank {self.rank}, got {rank}")
        out: list[Any] = [None] * self.n_ranks
        dist.all_gather_object(out, np.ascontiguousarray(message), group=self.group)
        return [out[r] for r in range(self.n_ranks) if r != rank]


class _RelayedError(RuntimeError):
    """The slice leader's exchange failed: what its slice's other ranks
    raise."""


class SliceRelay:
    """The cross-slice transport as the ranks of one slice see it: the
    leader exchanges over ``transport`` and broadcasts the peers'
    messages (or its failure) to its slice over the mesh's
    ``relay_group``; the other ranks never touch the transport and
    receive them.  Every rank of the slice then decodes the same bytes."""

    def __init__(self, mesh: MultiSliceMesh, transport=None):
        if mesh.is_leader and transport is None:
            raise ValueError("a slice leader needs a transport")
        self.mesh = mesh
        self.transport = transport if mesh.is_leader else None

    def exchange(self, rank: int, message: np.ndarray) -> list[np.ndarray]:
        import torch.distributed as dist
        mesh = self.mesh
        box: list[Any] = [None]
        if mesh.is_leader:
            try:
                box[0] = self.transport.exchange(rank, message)
            except BaseException as e:
                if mesh.data_per_slice > 1:
                    fail = [_RelayedError(f"slice {mesh.slice_index}'s leader failed its "
                                          f"exchange: {e!r}")]
                    dist.broadcast_object_list(fail, src=mesh.leader(), group=mesh.relay_group)
                raise
        if mesh.data_per_slice > 1:
            dist.broadcast_object_list(box, src=mesh.leader(), group=mesh.relay_group)
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]


class InProcessTransport:
    """N-rank in-process message router (``DummyTransport`` parity): each
    rank posts its wire message; ``exchange`` waits for every rank and
    returns the peers' messages of the same round.  Rounds are counted per
    rank, so a fast rank in round k+1 waits for every peer's round-k+1
    post and never picks up a stale round-k payload."""

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks
        self._lock = threading.Condition()
        self._rounds: dict[int, dict[int, np.ndarray]] = {}
        self._rank_round: dict[int, int] = {r: 0 for r in range(n_ranks)}

    def exchange(self, rank: int, message: np.ndarray) -> list[np.ndarray]:
        with self._lock:
            generation = self._rank_round[rank]
            self._rank_round[rank] += 1
            bucket = self._rounds.setdefault(generation, {})
            bucket[rank] = message
            if len(bucket) == self.n_ranks:
                self._lock.notify_all()
            else:
                while len(self._rounds[generation]) < self.n_ranks:
                    if not self._lock.wait(timeout=30.0):
                        raise TimeoutError(f"rank {rank} round {generation}: peers missing "
                                           f"({sorted(self._rounds[generation])})")
            result = [self._rounds[generation][r] for r in range(self.n_ranks) if r != rank]
            # free the rounds every rank has moved past
            oldest_active = min(self._rank_round.values())
            for g in [g for g in self._rounds if g < oldest_active - 1]:
                del self._rounds[g]
            return result


_FRAME = struct.Struct("<qqqq")    # round, rank, dtype code, element count
_DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.int32),
           2: np.dtype(np.float64), 3: np.dtype(np.int64)}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during frame")
        buf.extend(chunk)
    return bytes(buf)


def _send_frame(sock: socket.socket, rnd: int, rank: int, payload: np.ndarray) -> None:
    payload = np.ascontiguousarray(payload)
    code = _DTYPE_CODES[payload.dtype]   # the dtype travels: bit-exact
    sock.sendall(_FRAME.pack(rnd, rank, code, payload.size) + payload.tobytes())


def _recv_frame(sock: socket.socket):
    rnd, rank, code, count = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    dt = _DTYPES[code]
    data = np.frombuffer(_recv_exact(sock, count * dt.itemsize), dtype=dt)
    return rnd, rank, data


class SocketTransport:
    """Ring transport between slice-leader processes over TCP (loopback
    on one machine, any reachable hosts across machines), with
    :class:`InProcessTransport`'s ``exchange`` contract.

    Rank r binds ``port + r`` and accepts ONE connection, from its left
    neighbour ``(r-1) % n``; it connects out to its right neighbour's
    port.  ``exchange`` is a ring all-gather: at hop s a rank forwards the
    message that started s-1 hops upstream and receives the one from s
    hops upstream, so after n-1 hops every rank holds every origin's
    payload; each rank sends (n-1) messages a round whatever n is.

    A dead peer stalls its neighbours' receive, which raises
    ``socket.timeout`` (an ``OSError``) out of ``exchange``."""

    def __init__(self, rank: int, n_ranks: int, port: int, host: str = "127.0.0.1",
                 timeout: float = 60.0, hosts: Optional[Sequence[str]] = None,
                 bind_host: str = ""):
        """``host`` binds and connects on one address (loopback); for a
        ring across machines pass ``hosts``, one reachable address per
        rank, and optionally ``bind_host`` (default: every interface)."""
        self.rank = rank
        self.n_ranks = n_ranks
        self._round = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        right = (rank + 1) % n_ranks
        if hosts is None:
            hosts = [host] * n_ranks
            bind_host = bind_host or host
        if len(hosts) != n_ranks:
            raise ValueError(f"hosts must list all {n_ranks} ranks")
        self._listener = socket.create_server((bind_host, port + rank), backlog=1)
        self._listener.settimeout(timeout)
        # connect out to the right neighbour while it may still be binding;
        # the left neighbour waits in the backlog meanwhile
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._send_sock = socket.create_connection((hosts[right], port + right),
                                                           timeout=timeout)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._send_sock.settimeout(timeout)
        self._recv_sock, _ = self._listener.accept()
        self._recv_sock.settimeout(timeout)
        self._listener.close()

    def _send(self, rnd: int, origin: int, payload: np.ndarray) -> None:
        _send_frame(self._send_sock, rnd, origin, payload)
        self.bytes_sent += _FRAME.size + payload.nbytes

    def exchange(self, rank: int, message: np.ndarray) -> list[np.ndarray]:
        if rank != self.rank:
            raise ValueError(f"transport bound to rank {self.rank}, got {rank}")
        rnd = self._round
        self._round += 1
        n = self.n_ranks
        have: dict[int, np.ndarray] = {rank: np.ascontiguousarray(message)}
        forward, forward_origin = have[rank], rank
        for hop in range(1, n):
            # send on a helper thread while this one drains the receive:
            # with every rank in a blocking sendall, a payload larger than
            # the socket buffers would deadlock the ring
            send_err: list[BaseException] = []

            def _send_guarded(rnd=rnd, origin=forward_origin, data=forward):
                try:
                    self._send(rnd, origin, data)
                except BaseException as e:   # re-raised on the caller
                    send_err.append(e)

            sender = threading.Thread(target=_send_guarded)
            sender.start()
            try:
                got_rnd, origin, data = _recv_frame(self._recv_sock)
            finally:
                sender.join()
            if send_err:
                raise send_err[0]
            if got_rnd != rnd:
                raise RuntimeError(f"round mismatch: at {rnd}, received {got_rnd}")
            expected = (rank - hop) % n
            if origin != expected:
                raise RuntimeError(f"ring order violated: expected origin {expected}, "
                                   f"got {origin}")
            self.bytes_received += _FRAME.size + data.nbytes
            have[origin] = data
            forward, forward_origin = data, origin
        return [have[r] for r in range(n) if r != rank]

    def close(self):
        for s in (self._send_sock, self._recv_sock):
            try:
                s.close()
            except OSError:
                pass


class CompressedAllReducer:
    """One slice leader's side of the compressed cross-slice allreduce.
    ``allreduce(flat_grad)`` returns the SUM of every slice's gradient,
    each slice's share threshold-encoded on the wire and its quantization
    error carried in the local residual (the reference's error-feedback
    loop): approximate per step, unbiased over steps."""

    def __init__(self, rank: int, size: int, transport,
                 algorithm: Optional[AdaptiveThresholdAlgorithm] = None,
                 use_native: bool = True, value_coded: bool = False,
                 max_elements: Optional[int] = None):
        self.rank = rank
        self.size = int(size)
        self.transport = transport
        self.accumulator = EncodedGradientsAccumulator(
            (self.size,), algorithm=algorithm, use_native=use_native, value_coded=value_coded,
            max_elements=max_elements)
        self.last_message: Optional[np.ndarray] = None

    def allreduce(self, flat_grad: np.ndarray) -> np.ndarray:
        flat_grad = np.ravel(np.asarray(flat_grad, dtype=np.float32))
        if flat_grad.size != self.size:
            raise ValueError(f"gradient size {flat_grad.size} != {self.size}")
        message = self.accumulator.store_update(flat_grad)
        self.last_message = message
        peers = self.transport.exchange(self.rank, message)
        # this slice's share is what went on the wire (its message
        # decoded), not the raw gradient; the sum runs in GLOBAL RANK
        # ORDER, so every rank adds the same f32 numbers in the same order
        ordered = peers[:self.rank] + [message] + peers[self.rank:]
        total = np.zeros(self.size, np.float32)
        for msg in ordered:
            threshold_decode(msg, (self.size,), out=total)
        return total

    def wire_stats(self, message: np.ndarray) -> dict:
        n = int(message[0])
        return {"encoded": n, "dense_bytes": self.size * 4,
                "wire_bytes": int(message.size) * 4,
                "compression": self.size / max(message.size, 1)}
