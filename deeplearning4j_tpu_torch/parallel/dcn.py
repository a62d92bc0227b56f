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

Not ported yet: ``make_multislice_mesh`` (it comes with the mesh
layouts).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.parallel.compression import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator, threshold_decode)


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
